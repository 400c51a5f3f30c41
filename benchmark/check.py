"""The comparison that decides `correct`.

Every stream the window finished is held to the plain reference
(``benchmark/reference``), which works everything out again from the same
PCM and imports nothing of the program:

- ``failed_calls``: calls that raised (limit 0);
- ``stream_faults``: streams whose STREAMINFO (rate, channels, depth,
  block sizes, total samples, frame sizes, the MD5 of the PCM) is wrong,
  whose frames do not chain (every frame's header, its CRC-8, its number
  and block size), or whose bytes differ from the first finished stream of
  the same source (limit 0);
- ``lossless_faults``: sampled frames whose bytes do not decode, CRC-16
  checked, to their PCM (limit 0);
- ``frames_differ_pct``: the share of sampled frames whose bytes differ
  from the reference's frame: every decision (stereo assignment, subframe
  kind, fixed order, QLPC order, precision, shift and coefficients, Rice
  partition order and parameters), the header, the residual coding and the
  CRCs. Its limit comes from the configuration file.

The sample is drawn from the seed over every frame of every finished call,
and takes in the last (ragged) frame of every source.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import importlib
import os
import pickle
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

from .reference import encoder as ref_encoder
from .reference import flac

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECK_KEYS = ("failed_calls", "stream_faults", "lossless_faults", "frames_differ_pct")


def pcm_md5(pcm: np.ndarray, bps: int) -> bytes:
    """MD5 of interleaved little-endian samples of ceil(bps / 8) bytes."""
    width = (bps + 7) // 8
    raw = pcm.astype("<i4").reshape(-1).view(np.uint8).reshape(-1, 4)[:, :width]
    return hashlib.md5(np.ascontiguousarray(raw).tobytes()).digest()


def _frame_task(task) -> tuple:
    """(equal to the reference, decodes to its PCM, note) for one sampled
    frame; runs in a worker process."""
    enc, fmt, number, block, got = task
    want = ref_encoder.encode_frame(enc, block, fmt["sample_rate"], fmt["bits_per_sample"],
                                    number)
    if got == want:
        return True, True, ""
    try:
        dec = flac.decode_frame(got, fmt["sample_rate"], fmt["bits_per_sample"], fmt["channels"])
        lossless = dec.shape == block.shape and bool(np.array_equal(dec, block))
        note = "" if lossless else "decodes to other samples"
    except (flac.FormatError, IndexError, KeyError, ValueError) as e:
        lossless, note = False, f"does not decode: {e}"
    return False, lossless, note


def workers() -> int:
    return max(1, min(16, len(os.sched_getaffinity(0))))


def run_frames(tasks: List[tuple], n_workers: Optional[int] = None, fn=_frame_task) -> List:
    """`fn` (a function of this package, `_frame_task` by default) over
    every task, in worker processes that each take a share of the tasks
    through a pipe and have ended before this returns. Pipes, not a
    multiprocessing pool, whose locks would live in /dev/shm."""
    n = min(n_workers or workers(), len(tasks))
    if n <= 1:
        return [fn(t) for t in tasks]
    shares = [tasks[i::n] for i in range(n)]
    module = fn.__module__
    if module == "__main__":  # run as ``python3 -m benchmark.<module>``
        module = sys.modules["__main__"].__spec__.name
    procs = [subprocess.Popen([sys.executable, "-m", "benchmark.check", "--worker"],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=ROOT)
             for _ in range(n)]

    def feed(i):
        out, _ = procs[i].communicate(pickle.dumps((module, fn.__name__, shares[i])))
        if procs[i].returncode:
            raise RuntimeError(f"check worker {i} exited with {procs[i].returncode}")
        return pickle.loads(out)

    try:
        with concurrent.futures.ThreadPoolExecutor(n) as pool:
            done = list(pool.map(feed, range(n)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    results = [None] * len(tasks)
    for i, part in enumerate(done):
        results[i::n] = part
    return results


def _worker() -> None:
    """A worker of `run_frames`: tasks on stdin, results on stdout."""
    module, name, tasks = pickle.loads(sys.stdin.buffer.read())
    fn = getattr(importlib.import_module(module), name)
    sys.stdout.buffer.write(pickle.dumps([fn(t) for t in tasks]))


def sample_frames(frames_per_call: Sequence[int], n: int, seed: int) -> List[tuple]:
    """[(call, frame)]: `n` frames drawn without replacement, from the
    seed, over every frame of every call."""
    total = int(sum(frames_per_call))
    if not total:
        return []
    rng = np.random.default_rng([seed, 2])
    picks = np.sort(rng.choice(total, size=min(n, total), replace=False))
    ends = np.cumsum(frames_per_call)
    calls = np.searchsorted(ends, picks, side="right")
    return [(int(c), int(p - (ends[c] - frames_per_call[c]))) for c, p in zip(calls, picks)]


def _stream_fault(data: bytes, pcm: np.ndarray, fmt: dict, block: int) -> tuple:
    """(None or what is wrong, the frame index) of one stream."""
    try:
        info = flac.read_streaminfo(data)
    except (flac.FormatError, IndexError) as e:
        return f"STREAMINFO: {e}", None
    n = pcm.shape[0]
    # the upstream encoder states its largest frame's block size as both
    # bounds: the fixed size, or a shorter source's length
    want = dict(rate=fmt["sample_rate"], channels=fmt["channels"], bps=fmt["bits_per_sample"],
                total_samples=n, min_block=min(block, n), max_block=min(block, n),
                md5=pcm_md5(pcm, fmt["bits_per_sample"]))
    for k, v in want.items():
        if getattr(info, k) != v:
            return f"STREAMINFO {k} {getattr(info, k)!r} != {v!r}", None
    try:
        index = flac.index_frames(data, info)
    except (flac.FormatError, IndexError, KeyError) as e:
        return f"frames: {e}", None
    count = -(-n // block)
    if len(index) != count:
        return f"{len(index)} frames, {count} due", None
    for i, (_, _, h) in enumerate(index):
        if h.block_size != min(block, n - i * block):
            return f"frame {i} holds {h.block_size} samples", None
    sizes = [b - a for a, b, _ in index]
    if (info.min_frame, info.max_frame) != (min(sizes), max(sizes)):
        return f"frame sizes {info.min_frame}..{info.max_frame} != {min(sizes)}..{max(sizes)}", None
    return None, index


def _fmt_of(fmt: dict, source) -> dict:
    """The configuration's format at the source's own sample rate."""
    return dict(fmt, sample_rate=source.rate)


def check(sources: Sequence, calls: Sequence[dict], fmt: dict, encoder: dict, block: int,
          seed: int, n_sample: int, n_workers: Optional[int] = None) -> Dict:
    """The numbers compared, and notes, for the `calls` of a run: each a
    dict with "source" (its index in `sources`), "data" (its stream's bytes,
    None if it raised) and "error"."""
    out = {"failed_calls": sum(1 for c in calls if c.get("error")), "stream_faults": 0,
           "lossless_faults": 0, "frames_differ_pct": None, "frames_checked": 0, "notes": []}
    done = [c for c in calls if not c.get("error") and c.get("data") is not None]
    first: Dict[int, bytes] = {}
    digest: Dict[int, bytes] = {}
    for c in done:
        d = hashlib.sha256(c["data"]).digest()
        if c["source"] not in first:
            first[c["source"]], digest[c["source"]] = c["data"], d
        elif d != digest[c["source"]]:
            out["stream_faults"] += 1
            out["notes"].append(f"source {c['source']}: a later stream's bytes differ")
    index = {}
    for s, data in first.items():
        fault, idx = _stream_fault(data, sources[s].pcm, _fmt_of(fmt, sources[s]), block)
        if fault:
            out["stream_faults"] += 1
            out["notes"].append(f"source {s}: {fault}")
        else:
            index[s] = idx
    frames = [-(-sources[c["source"]].frames // block) for c in done]
    picks = {(done[c]["source"], f) for c, f in sample_frames(frames, n_sample, seed)}
    picks |= {(s, -(-sources[s].frames // block) - 1) for s in first}
    tasks, keys = [], []
    for s, f in sorted(picks):
        if s not in index:
            continue
        a, b, _ = index[s][f]
        pcm = sources[s].pcm[f * block:(f + 1) * block]
        tasks.append((encoder, _fmt_of(fmt, sources[s]), f, pcm, first[s][a:b]))
        keys.append((s, f))
    results = run_frames(tasks, n_workers)
    differ = [k for k, r in zip(keys, results) if not r[0]]
    for k, r in zip(keys, results):
        if not r[1]:
            out["lossless_faults"] += 1
            out["notes"].append(f"source {k[0]} frame {k[1]}: {r[2]}")
    out["frames_checked"] = len(tasks)
    if tasks:
        out["frames_differ_pct"] = 100.0 * len(differ) / len(tasks)
    if differ:
        out["notes"].append(f"frames that differ from the reference: {differ[:12]}")
    return out


def verdict(numbers: Dict, limits: Dict) -> tuple:
    """(correct, [(name, value, limit)]) with every number beside its limit."""
    rows = [(k, numbers.get(k), limits[k]) for k in CHECK_KEYS]
    correct = numbers.get("frames_checked", 0) > 0 and all(
        v is not None and v <= lim for _, v, lim in rows)
    return correct, rows


if __name__ == "__main__":
    if sys.argv[1:] != ["--worker"]:
        raise SystemExit("python3 -m benchmark.check --worker: a worker of run_frames")
    _worker()
