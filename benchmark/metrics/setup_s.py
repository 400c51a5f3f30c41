"""Process start to the window's start: imports, CUDA start, the native
and kernel libraries, audio synthesis and the cell's warm encodes."""


def read(run):
    return run.setup_s
