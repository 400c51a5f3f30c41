"""The least time one forward could take (`roofline.forward_work` at the
peaks) over its measured device time (`forward_device_ms`)."""

from .. import roofline
from . import forward_device_ms


def read(run):
    ms = forward_device_ms.read(run)
    if not ms:
        return None
    fmt = run.config["format"]
    work = roofline.forward_work(run.per_card_batch, fmt["channels"], run.config["block_size"],
                                 fmt["bits_per_sample"], run.config["encoder"])
    return 100.0 * roofline.bound_ms(work)[0] / ms
