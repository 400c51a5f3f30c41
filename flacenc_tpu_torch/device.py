"""Device resolution for the port (counterpart of ``flacenc_tpu/ops/jax_env.py``).

The JAX package switched on x64 globally; the port instead names
``torch.int64`` / ``torch.float64`` at every step that needs them, so the
only environment decision left is the device, and it is always explicit:
``"cuda"`` (the default of the public entry) raises when no card is
visible, and ``"cpu"`` runs only when a caller asks for it. Nothing ever
falls back from one to the other.

``"cuda"`` without an index names the current card, except in one rank of
a ``torch.distributed`` group of more than one process, where it names the
rank's own card (`rank_card`): each rank encodes on its own card, as each
JAX process encodes on its own ``jax.local_devices()``.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import NamedTuple

import torch


def multi_process() -> bool:
    """Whether this process is one rank of a `torch.distributed` group of
    more than one process."""
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def rank_card(n_cards: int) -> int:
    """The card index of this rank of a group: ``LOCAL_RANK`` (the rank on
    this host, which ``torchrun`` sets) modulo the `n_cards` visible cards.
    Without ``LOCAL_RANK`` the group rank stands for it when the group has
    no more ranks than the host has cards (one host); else this raises."""
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        dist = torch.distributed
        world = dist.get_world_size()
        if world > n_cards:
            raise RuntimeError(
                f"device 'cuda' in rank {dist.get_rank()} of a group of {world} processes "
                f"on a host with {n_cards} visible card(s): set LOCAL_RANK (torchrun does) "
                "or pass 'cuda:<index>'"
            )
        local = dist.get_rank()
    return int(local) % n_cards


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """`device` as a `torch.device`; raises if it names CUDA without a card
    or a card that is not visible, or a device type the port does not run
    on. ``"cuda"`` without an index is the current card, or in a rank of a
    multi-process group that rank's card (`rank_card`); ``"cuda:i"`` is
    always card i."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is false; pass device='cpu' to run on the CPU"
            )
        n_cards = torch.cuda.device_count()
        if dev.index is None:
            index = rank_card(n_cards) if multi_process() else torch.cuda.current_device()
            dev = torch.device("cuda", index)
        elif dev.index >= n_cards:
            raise RuntimeError(f"device {str(dev)!r} requested but {n_cards} card(s) are visible")
    elif dev.type != "cpu":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', not {str(dev)!r}")
    return dev


def on_card(dev: torch.device):
    """The per-thread CUDA state an issue needs, set on whichever thread
    runs it: `dev` current and its default stream current on it. Every
    replay, upload, download and event of a card goes on that one stream,
    whichever thread issues it, so a download enqueued before the next
    replay also runs before it. A no-op for the CPU."""
    stack = contextlib.ExitStack()
    if dev.type == "cuda":
        stack.enter_context(torch.cuda.device(dev))
        stack.enter_context(torch.cuda.stream(torch.cuda.default_stream(dev)))
    return stack


def name_card(error: BaseException, dev: torch.device) -> BaseException:
    """`error`, of its own type, with a note naming the device whose program
    raised it (over a mesh, which card failed); the note is added once."""
    note = f"raised by the program on {dev}"
    if note not in getattr(error, "__notes__", ()):
        error.add_note(note)
    return error


class LinkTiming(NamedTuple):
    """One timed run of host-to-device copies: the card, the bytes copied
    and the timing CUDA events recorded on its stream before and after."""

    device: str
    nbytes: int
    start: object
    end: object

    def seconds(self) -> float:
        """The copies' seconds on the card's clock; call it only once an
        event recorded after `end` has completed, so that nothing waits."""
        return self.start.elapsed_time(self.end) / 1e3


_UPLOADS = threading.local()  # the list `collect_uploads` gathers into on this thread


@contextlib.contextmanager
def collect_uploads():
    """Gathers, in the list it yields, the `LinkTiming` of every
    `timed_upload` block this thread runs inside it."""
    outer = getattr(_UPLOADS, "timings", None)
    _UPLOADS.timings = timings = []
    try:
        yield timings
    finally:
        _UPLOADS.timings = outer


@contextlib.contextmanager
def timed_upload(dev: torch.device, inputs):
    """Times the copies of `inputs` to card `dev` that the block enqueues
    on the card's current stream, between two timing events, for the
    `collect_uploads` around it. A no-op outside one, off a card, or where
    no input lives on the host."""
    timings = getattr(_UPLOADS, "timings", None)
    nbytes = 0
    if timings is not None and dev.type == "cuda":
        nbytes = sum(x.nbytes for x in inputs if x.device.type == "cpu")
    if not nbytes:
        yield
        return
    stream = torch.cuda.current_stream(dev)
    start = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    yield
    end = torch.cuda.Event(enable_timing=True)
    end.record(stream)
    timings.append(LinkTiming(str(dev), nbytes, start, end))
