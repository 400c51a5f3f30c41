"""The share of the profiled span in which no operation ran on a card,
the mean over the cards."""


def read(run):
    cards = (run.profile or {}).get("cards") or []
    if not cards or not run.profile.get("window_s"):
        return None
    busy = sum(c["busy_s"] for c in cards) / len(cards)
    return 100.0 * (1.0 - busy / run.profile["window_s"])
