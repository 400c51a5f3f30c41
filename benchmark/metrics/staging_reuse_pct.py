"""Share of the dispatch lane's pinned staging acquisitions (uploads and
downloads, on a card) served by a slot the process already kept:
100 x reused / (reused + allocated), summed over the window's finished
calls' `stats` (``staging_reused``, ``staging_allocated``); None where no
call counted any."""


def read(run):
    done = [c["stats"] for c in run.calls if not c["error"]]
    reused = sum(s.get("staging_reused") or 0 for s in done)
    allocated = sum(s.get("staging_allocated") or 0 for s in done)
    if not reused + allocated:
        return None
    return 100.0 * reused / (reused + allocated)
