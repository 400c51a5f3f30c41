"""Sums of the encoder's own counters over the window's calls."""


def per_batch_ms(run, key):
    done = [c for c in run.calls if not c["error"]]
    batches = sum(c["stats"].get("batches") or 0 for c in done)
    if not batches:
        return None
    return 1e3 * sum(c["stats"].get(key, 0.0) for c in done) / batches
