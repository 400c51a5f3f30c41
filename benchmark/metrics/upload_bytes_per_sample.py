"""Bytes a sample of the batches' uploads as shipped (after any fallback to
a warm wire): raw int32 reads 4.0, raw int16 2.0, the packed wires less.
The encoder's `stats["upload_bytes"]` over its `stats["upload_samples"]`
(the padded batches' samples), summed over the window's finished calls;
None where no call counted any."""


def read(run):
    done = [c["stats"] for c in run.calls if not c["error"]]
    nbytes = sum(s.get("upload_bytes") or 0 for s in done)
    samples = sum(s.get("upload_samples") or 0 for s in done)
    if not samples:
        return None
    return nbytes / samples
