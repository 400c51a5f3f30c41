"""The Rice cost-table kernel's least time (`roofline.kernel_bound_ms` at
the shape one forward launches it with) over its mean profiled time, the
mean over the cards."""

from .. import roofline


def read(run):
    cards = (run.profile or {}).get("cards") or []
    times = [c["rice_mean_s"] for c in cards if c.get("rice_mean_s")]
    if not times:
        return None
    fmt = run.config["format"]
    T = run.config["block_size"]
    rows = run.per_card_batch * roofline.candidates(fmt["channels"])
    bound = roofline.kernel_bound_ms(rows, T, roofline.finest_order(T))
    return 100.0 * bound / (1e3 * sum(times) / len(times))
