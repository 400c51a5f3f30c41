"""Device milliseconds of one forward: the union of the kernels' spans on
a card over the profiled span, over the forwards that ran there (the Rice
kernel runs twice a forward); the slowest card's."""


def read(run):
    cards = (run.profile or {}).get("cards") or []
    per = [c["kernel_busy_s"] / c["forwards"] * 1e3 for c in cards if c["forwards"]]
    return max(per) if per else None
