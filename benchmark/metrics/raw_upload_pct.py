"""Share of the batches shipped on raw PCM: 100 x the encoder's
`stats["upload_raw_batches"]` over its `stats["batches"]`, summed over the
window's finished calls that count raw batches; None where none does."""


def read(run):
    done = [c["stats"] for c in run.calls
            if not c["error"] and c["stats"].get("upload_raw_batches") is not None]
    batches = sum(s.get("batches") or 0 for s in done)
    if not batches:
        return None
    return 100.0 * sum(s["upload_raw_batches"] for s in done) / batches
