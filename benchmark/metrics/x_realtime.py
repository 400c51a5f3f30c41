"""Audio seconds of every call the window started, over the wall from the
window's start to the last of them finishing: every stall in the window
counts."""


def read(run):
    done = [c for c in run.calls if not c["error"]]
    if not done:
        return None
    return sum(c["audio_s"] for c in done) / (max(c["t1"] for c in done) - run.window_start)
