"""Graph captures the process made inside the window, on a dispatch lane
or on a capture thread: `batch_encoder.CAPTURE_COUNTS` before and after."""


def read(run):
    if run.captures is None:
        return None
    before, after = run.captures
    return float(after["lane"] + after["background"] - before["lane"] - before["background"])
