"""Whole native libraries for the JAX package in every test worker.

The port's tests compare its bytes with the JAX package's native packers.
That package builds ``libflacenc_packer.so`` and ``libflacenc_decoder.so``
with g++ straight into ``flacenc_tpu/native/`` on first use, takes any file
not older than its source as finished, and caches a failed load for the
whole process. Test workers that collect at once on a fresh checkout can
race there: one compiles while another loads the half-written file, and
that worker loses the package's native path for its whole session (tests
that need it skip, tests that compare the port against it fail).

`ensure_jax_native_libraries` runs while this module is collected. Every
worker collects the whole test tree before any test runs, and it collects
this directory first: pytest orders a directory's entries by name, and
``_native_guard`` sorts before every ``test_*.py`` file, so the libraries
are whole before any test file evaluates ``native.available()`` in a
``skipif`` at its collection. Under an fcntl lock beside the
libraries it loads each one with the package's own loader (after a child
process has shown that the file loads: a half-written library can also
kill the process that maps it, with SIGBUS); a library that does not load
is compiled again by the package's own g++ command into a
temporary file, moved into place with `os.replace`, and loaded again after
the package's cached load state is reset. The package itself is not changed.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import sys
import tempfile

import pytest

from flacenc_tpu import native as jax_native
from flacenc_tpu.native import build as jax_build
from flacenc_tpu.native import independent as jax_independent

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))

# (loader module, name of its source in build.py, name of its library there)
_LIBRARIES = (
    (jax_native, "SRC", "LIB"),
    (jax_independent, "DEC_SRC", "DEC_LIB"),
)


def _reload(module) -> bool:
    """Forget `module`'s cached load (library or error) and load again."""
    module._lib = None
    module._load_error = None
    return module._load() is not None


def _loads_whole(lib: str) -> bool:
    """Whether `lib` loads, tried in a child process: a half-written
    library can kill the process that maps it (SIGBUS), not only fail."""
    probe = "import ctypes, sys; ctypes.CDLL(sys.argv[1])"
    return subprocess.run([sys.executable, "-c", probe, lib], capture_output=True,
                          timeout=60).returncode == 0


def _rebuild(src: str, lib: str) -> None:
    """The package's own g++ command into a temporary file beside `lib`,
    then moved over it in one step, so no process sees it half written."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(lib), suffix=".so.tmp")
    os.close(fd)
    try:
        jax_build._compile(src, tmp, force=True)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def ensure_jax_native_libraries() -> dict:
    """Make both libraries of the JAX package load whole in this process:
    {library path: "loaded" | "rebuilt"}. Raises when a rebuilt library
    still does not load."""
    state = {}
    lib_dir = os.path.dirname(jax_build.LIB)
    with open(os.path.join(lib_dir, ".flacenc_native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for module, src_name, lib_name in _LIBRARIES:
            src, lib = getattr(jax_build, src_name), getattr(jax_build, lib_name)
            fresh = os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src)
            if module._lib is not None or (fresh and _loads_whole(lib) and _reload(module)):
                state[lib] = "loaded"
                continue
            _rebuild(src, lib)
            if not _reload(module):
                raise RuntimeError(f"{lib} does not load after a rebuild: {module._load_error!r}")
            state[lib] = "rebuilt"
    return state


# every worker collects this module before any other test module
COLLECTION_STATE = ensure_jax_native_libraries()


def test_both_jax_libraries_loaded_at_collection():
    assert set(COLLECTION_STATE) == {jax_build.LIB, jax_build.DEC_LIB}
    assert jax_native.available() and jax_independent.available()


def test_guard_restores_a_truncated_library(tmp_path):
    """A process whose loader met truncated copies of both libraries (the
    state a lost race leaves) has the package's native path back after the
    guard runs, and the files on disk are whole again."""
    code = f"""
import os, sys
sys.path[:0] = [{REPO!r}, {HERE!r}]
from flacenc_tpu.native import build
from flacenc_tpu import native
from flacenc_tpu.native import independent
for name in ("LIB", "DEC_LIB"):
    whole = open(getattr(build, name), "rb").read()
    part = os.path.join({str(tmp_path)!r}, os.path.basename(getattr(build, name)))
    with open(part, "wb") as f:
        f.write(whole[:64])  # an ELF header, as a half-written file begins
    setattr(build, name, part)  # newer than its source: taken as built
assert not native.available() and not independent.available()
import test_torch_atomic_native as guard  # runs the guard, as collection does
assert set(guard.COLLECTION_STATE.values()) == {{"rebuilt"}}, guard.COLLECTION_STATE
assert native.available() and independent.available()
assert native.scan_upload(__import__("numpy").zeros((1, 32), "int32")) == (1, 8)
for name in ("LIB", "DEC_LIB"):
    import ctypes
    ctypes.CDLL(getattr(build, name))  # the file on disk loads in a new handle
print("restored")
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=240, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "restored" in r.stdout


@pytest.mark.parametrize("which", ["LIB", "DEC_LIB"])
def test_a_failed_load_is_cached_until_the_guard_resets_it(which, tmp_path, monkeypatch):
    """The package caches a failed load; `_reload` forgets it, so a whole
    library loads again in the same process."""
    module = jax_native if which == "LIB" else jax_independent
    monkeypatch.setattr(module, "_lib", None)
    monkeypatch.setattr(module, "_load_error", OSError("file too short"))
    assert module._load() is None  # cached: the whole file is never tried
    assert _reload(module)
