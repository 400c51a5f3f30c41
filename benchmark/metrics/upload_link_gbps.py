"""The host-to-device link's rate as the card's CUDA events timed the
uploads: Σ `stats["link_bytes"]` / Σ `stats["link_s"]` / 1e9 over the
window's finished calls; None where no call timed any (the CPU, or a
program without the counters)."""


def read(run):
    done = [c["stats"] for c in run.calls if not c["error"]]
    nbytes = sum(s.get("link_bytes") or 0 for s in done)
    seconds = sum(s.get("link_s") or 0.0 for s in done)
    if not nbytes or seconds <= 0:
        return None
    return nbytes / seconds / 1e9
