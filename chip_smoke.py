#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (flacenc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
them against their plain PyTorch version and times the Rice cost-table
kernel at the main path's shape, L2-warm and L2-cold, beside its bound.
Then it drives every encode path of the port through its public entries on
the card, each at a size users run:

- CD stereo, the default config (240 s), and a sigen clip against the
  numpy oracle;
- fixed-only mono (120 s), 24-bit / 96 kHz stereo (60 s);
- experimental direct MSE (30 s) and IRLS (10 s), a sigen clip against
  the oracle;
- BitCount fixed-order selection (60 s), a sigen clip against the oracle;
- strict mode (60 s), a sigen clip with a ragged tail against the oracle's
  strict encoder;
- a corpus of 8 WAV files of 30-240 s at two sample rates, each stream
  equal to the file encoded alone;
- the command line: encode a WAV on the card, decode it back.

Every path decodes losslessly with two decoders and its MD5 matches; one
batch of its blocks gives the same decisions on the card as on the CPU;
and the Rice kernel's launch count equals what the config implies. Every
failure raises; the script exits 0 only when every phase passed. Its last
line is one JSON object naming the card; the line before it lists each
kernel with its launches on every path and its times.

It needs a CUDA card (exits non-zero without one) and imports neither JAX
nor the JAX package. `--kernel-only` stops after the kernel checks;
`--compare-with OLD.cu` also times a kernel built from another source of
``csrc/rice_tables.cu`` (the first kernel's C entry) against this one, in
turns.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int = 20, reps: int = 10) -> float:
    """Device time of one fn() call in ms: `iters` calls captured in a CUDA
    graph, replayed `reps` times between CUDA events, so host launch
    overhead does not enter the figure."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm-up before capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def cuda_ms_rotating(fns, reps: int = 10) -> float:
    """Device time of one call in ms, each of `fns` called once in turn per
    captured round (as `cuda_ms`, with the round replayed `reps` times)."""
    calls = itertools.cycle(fns)
    return cuda_ms(lambda: next(calls)(), iters=2 * len(fns), reps=reps)


def eager_ms(fn, iters: int = 200) -> float:
    """Wall time of one eager fn() call in ms, host launch cost included."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def tone_audio(seconds: float, seed: int, rate: int = 44100, bps: int = 16,
               channels: int = 2):
    """Interleaved PCM: a few seeded, slowly swelling partials per channel
    over low-level noise (sigma 0.004 of full scale)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n, dtype=np.float64) / rate
    full = (1 << (bps - 1)) - 1
    x = np.empty(channels * n, np.int32)
    for ch in range(channels):
        sig = np.zeros(n)
        for _ in range(6):
            f = rng.uniform(60.0, 4000.0)
            amp = rng.uniform(0.02, 0.12)
            swell = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.05, 0.5) * t)
            sig += amp * swell * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
        sig += rng.normal(0.0, 0.004, n)
        x[ch::channels] = np.clip(np.round(sig * full), -full - 1, full).astype(np.int32)
    return x


def cd_audio(seconds: int, seed: int):
    """Interleaved 16-bit stereo at 44.1 kHz (`tone_audio`)."""
    return tone_audio(seconds, seed)


def sigen_clip(n: int, channels: int = 2):
    """The sigen clip of the oracle comparisons: sines at 128 and 130 Hz."""
    import numpy as np

    from flacenc_tpu_torch import sigen

    x = np.zeros(channels * n, np.int32)
    for ch in range(channels):
        x[ch::channels] = sigen.Sine(128 + 2 * ch, 0.4).noise_with_seed(
            ch + 1, 0.01).to_vec_quantized(16, n)
    return x


def kernel_cases():
    """(name, errors (B, K, T) int32, warmup (B, K) int32) on which the kernel
    must equal its plain version: the main path's shape first, the other
    partition layouts, every warmup, saturation and residuals near +-2^31."""
    import numpy as np

    rng = np.random.default_rng(7)
    cases = []

    def add(name, errors, warmup):
        cases.append((name, errors.astype(np.int32), warmup.astype(np.int32)))

    for T in (4096, 1024, 16384, 4095, 32767):
        B, K = (64, 4) if T == 4096 else (8, 4)
        add(f"random T={T} B*K={B * K}", rng.integers(-(1 << 20), 1 << 20, (B, K, T)),
            rng.integers(0, 25, (B, K)))
    add("warmups 0..24", rng.integers(-3000, 3000, (25, 1, 4096)),
        np.arange(25)[:, None])
    sat = np.zeros((1, 1, 4096))
    sat[0, 0, :8] = -(1 << 27)
    add("saturation", sat, np.zeros((1, 1)))
    near = np.zeros((2, 1, 1024))
    near[0, 0, :2] = [(1 << 30) + 1, -((1 << 30) + 2)]
    near[0, 0, 70] = np.iinfo(np.int32).min
    near[1, 0] = rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max, 1024)
    add("near +-2^31", near, np.array([[0], [3]]))
    return cases


HBM_BYTES_PER_S = 3.35e12  # H100 SXM, the published rate at 700 W
INT_OPS_PER_S = 67e12  # the published float32 rate outside the tensor cores


def kernel_bound_ms(rows: int, T: int, finest: int) -> float:
    """Least time of one call on an H100: the larger of its bytes (residuals
    and warmups read once, tables written once) over the memory rate and its
    operations (a shift and an add for every sample and p) over the
    non-tensor rate."""
    nbytes = rows * T * 4 + rows * 4 + rows * (1 << finest) * 32 * 4
    ops = 2 * 32 * rows * T
    return max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S) * 1e3


def cold_inputs(errors, warmup, n: int = 16):
    """`n` copies of the inputs on the card, together larger than the 50 MB
    L2, so that a launch on each in turn finds its input in device memory."""
    import torch

    copies = [(errors.clone(), warmup.clone()) for _ in range(n)]
    total = n * (errors.numel() * 4 + warmup.numel() * 4)
    if total <= 50e6:
        raise ValueError(f"{n} input copies hold {total} bytes, not more than the L2")
    torch.cuda.synchronize()
    return copies


def check_kernel(rice_tables, finest_partition_order, dev):
    """Kernel == plain on the card, exactly, on every `kernel_cases` case;
    then the kernel's times at the main-path shape (B*K = 256, T = 4096),
    L2-warm (one input) and L2-cold (16 inputs in turn), beside its bound
    and the plain version's time. Returns a dict of the numbers."""
    import torch

    max_err = 0
    for name, errors, warmup in kernel_cases():
        T = errors.shape[-1]
        finest = finest_partition_order(T, 64)
        e = torch.from_numpy(errors).to(dev)
        w = torch.from_numpy(warmup).to(dev)
        plan = rice_tables.launch_plan(T, finest, e.data_ptr())
        got = rice_tables.rice_cost_tables(e, w, finest)
        torch.cuda.synchronize()
        exp = rice_tables.rice_cost_tables_plain(e, w, finest)
        err = int((got.to(torch.int64) - exp.to(torch.int64)).abs().max())
        print(f"kernel vs plain: {name}: finest={finest} {plan} max_abs_err={err}")
        if err or not torch.equal(got, exp):
            raise AssertionError(f"rice_cost_tables differs from its plain version: {name}")
        max_err = max(max_err, err)

    _, errors, warmup = kernel_cases()[0]  # (64, 4, 4096): the main path's shape
    e = torch.from_numpy(errors).to(dev)
    w = torch.from_numpy(warmup).to(dev)
    if rice_tables.launch_plan(4096, 6, e.data_ptr()).kernel != "mma":
        raise AssertionError("the main path's shape does not take the tensor-core kernel")
    copies = cold_inputs(e, w)
    kernel = lambda: rice_tables.rice_cost_tables(e, w, 6)  # noqa: E731
    plain = lambda: rice_tables.rice_cost_tables_plain(e, w, 6)  # noqa: E731
    cold = [lambda a=a, b=b: rice_tables.rice_cost_tables(a, b, 6) for a, b in copies]
    lib = rice_tables._load()
    out = torch.empty((64, 4, 64, 32), dtype=torch.int32, device=dev)

    def transpose():  # the other kernel, at the main path's shape
        rc = lib.flacenc_rice_cost_tables_transpose(
            e.data_ptr(), w.data_ptr(), out.data_ptr(), 256, 4096, 6,
            rice_tables.launch_plan(4096, 6, 4).parts_per_block,  # its plan for this shape
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"transpose kernel launch failed: {rc}")

    transpose()
    if not torch.equal(out, plain()):
        raise AssertionError("the transpose kernel differs from the plain version")
    times = {
        "ms": cuda_ms(kernel),
        "cold_ms": cuda_ms_rotating(cold),
        "plain_ms": cuda_ms(plain),
        "transpose_ms": cuda_ms(transpose),
    }
    bound = kernel_bound_ms(256, 4096, 6)
    times.update(max_abs_err=max_err, bound_ms=bound, bound_by="bytes",
                 share_warm=bound / times["ms"], share_cold=bound / times["cold_ms"])
    print(f"rice_cost_tables at B*K=256 T=4096 (CUDA graph replay): L2-warm "
          f"{times['ms']} ms, L2-cold {times['cold_ms']} ms, bound {bound} ms (bytes), "
          f"share of bound warm {times['share_warm']} cold {times['share_cold']}; "
          f"plain {times['plain_ms']} ms; the transpose kernel at this shape "
          f"{times['transpose_ms']} ms; eager with host launch: kernel "
          f"{eager_ms(kernel)} ms ({card_line()})")
    return times


def compare_with(path: str, dev, rounds: int = 3) -> dict:
    """Times the kernel built from another source of ``csrc/rice_tables.cu``
    (the first kernel's C entry: errors, warmup, out, rows, block size,
    finest order, stream) against this checkout's, in turns (old, new, new,
    old, ...), L2-warm and L2-cold, at the main-path shape; both must give
    the same tables."""
    import ctypes
    import torch

    from flacenc_tpu_torch.csrc import build as kbuild
    from flacenc_tpu_torch.ops import rice_tables

    with tempfile.TemporaryDirectory() as out_dir:
        lib_path = os.path.join(out_dir, "librice_old.so")
        subprocess.run([kbuild.find_nvcc(), *kbuild.NVCC_FLAGS, "-o", lib_path, path],
                       check=True, capture_output=True, text=True)
        old = ctypes.CDLL(lib_path)  # stays loaded after its file is removed
    old.flacenc_rice_cost_tables.restype = ctypes.c_int
    old.flacenc_rice_cost_tables.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]

    _, errors, warmup = kernel_cases()[0]
    e = torch.from_numpy(errors).to(dev)
    w = torch.from_numpy(warmup).to(dev)
    copies = cold_inputs(e, w)

    def run_old(a, b):
        out = torch.empty((64, 4, 64, 32), dtype=torch.int32, device=dev)
        rc = old.flacenc_rice_cost_tables(a.data_ptr(), b.data_ptr(), out.data_ptr(), 256,
                                          4096, 6, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"old kernel launch failed: {rc}")
        return out

    new_out = rice_tables.rice_cost_tables(e, w, 6)
    if not torch.equal(run_old(e, w), new_out):
        raise AssertionError("the old and the new kernel give different tables")
    result = {"old_ms": [], "new_ms": [], "old_cold_ms": [], "new_cold_ms": []}
    for i in range(2 * rounds):
        order = ("old", "new") if i % 2 == 0 else ("new", "old")
        for which in order:
            fn = run_old if which == "old" else (lambda a, b: rice_tables.rice_cost_tables(a, b, 6))
            result[f"{which}_ms"].append(cuda_ms(lambda: fn(e, w)))
            result[f"{which}_cold_ms"].append(
                cuda_ms_rotating([lambda a=a, b=b: fn(a, b) for a, b in copies]))
    print("kernel comparison (old source " + path + "): " + json.dumps(result) + f" ({card_line()})")
    return result


def check_ties(config, tbe, fixed, rice, dev):
    """The three first-minimum sites pick the first tie on the card."""
    import numpy as np
    import torch

    from flacenc_tpu_torch import sigen

    # stereo mode: L == R makes LS, RS and MS cost the same -> LS (code 1)
    n = 8 * 1024
    left = sigen.Sine(128, 0.4).noise_with_seed(1, 0.01).to_vec_quantized(16, n)
    blocks = torch.from_numpy(
        np.stack([left, left]).reshape(2, 8, 1024).transpose(1, 0, 2).copy()
    )
    enc = tbe.BatchEncoder(config.Encoder(), 2, 16, 1024)
    cpu = enc(blocks)
    gpu = enc.to(dev)(blocks.to(dev)).cpu()
    if not torch.equal(cpu, gpu) or not bool((gpu[:, 0] == 1).all()):
        raise AssertionError("stereo-mode tie: the card did not pick LS")

    # Rice order: seed-2 rows 0 and 17 tie between orders 1 and 0 -> order 1
    rng = np.random.default_rng(2)
    errors = rng.integers(-40, 40, (32, 1, 128)).astype(np.int32)
    errors[:, :, 64:] *= rng.integers(1, 5, (32, 1, 1)).astype(np.int32)
    e = torch.from_numpy(errors)
    w = torch.zeros((32, 1), dtype=torch.int32)
    r_cpu = rice.find_partitioned_rice_parameters(e, w, 128, 30)
    r_gpu = rice.find_partitioned_rice_parameters(e.to(dev), w.to(dev), 128, 30)
    for a, b in zip(r_cpu, r_gpu):
        if not torch.equal(a, b.cpu()):
            raise AssertionError("Rice search differs between the card and the CPU")
    if r_gpu.partition_order[[0, 17], 0].tolist() != [1, 1]:
        raise AssertionError("Rice order tie: the card did not keep the finest order")

    # fixed order: argmin over the card's own ApproxEnt costs takes the first
    sig = torch.from_numpy(
        np.random.default_rng(300).integers(-3, 4, (32, 1, 64)).astype(np.int32)
    )
    est = {}
    for name, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        errs = fixed.fixed_lpc_errors(sig.to(d))
        est[name] = torch.stack([
            fixed.estimate_entropy(
                errs[:, :, o, :], torch.full((32, 1), o, dtype=torch.int32, device=d), 16, 64
            ) + 16 * o
            for o in range(5)
        ], dim=-1)
    est_gpu = est["cuda"]
    first = np.argmin(est_gpu.cpu().numpy(), axis=-1)
    if not np.array_equal(torch.argmin(est_gpu, dim=-1).cpu().numpy(), first):
        raise AssertionError("fixed-order argmin on the card is not the first minimum")
    n_ties = int(((est_gpu == est_gpu.amin(-1, keepdim=True)).sum(-1) > 1).sum())
    same = torch.equal(est["cpu"], est_gpu.cpu())
    print(f"ties on the card: stereo LS ok, rice finest ok, fixed-order first-min ok "
          f"({n_ties} tied rows; ApproxEnt equal to CPU: {same})")


def default_config():
    """`config.Encoder()`, verified: the CLI's and the main path's config."""
    from flacenc_tpu_torch import config

    return config.Encoder().into_verified().inner


def rice_per_forward(cfg, block_size: int) -> int:
    """Rice kernel launches one BatchEncoder forward makes under `cfg`: one
    search for the ApproxEnt fixed order (one per order 0..max_order under
    BitCount) and one for QLPC; none below the prediction minimum."""
    from flacenc_tpu_torch import constants

    sub = cfg.subframe_coding
    if block_size < constants.MIN_BLOCK_SIZE_FOR_PREDICTION:
        return 0
    fixed = 0
    if sub.use_fixed:
        fixed = sub.fixed.max_order + 1 if sub.fixed.order_sel.type == "BitCount" else 1
    return fixed + (1 if sub.use_lpc else 0)


def first_batch(x, channels: int, block_size: int, batch: int = 64):
    """The first `batch` full blocks of interleaved `x` as (B, C, T) int32."""
    import numpy as np

    n = min(batch, len(x) // channels // block_size)
    return x[: n * block_size * channels].reshape(n, block_size, channels) \
        .transpose(0, 2, 1).astype(np.int32).copy()


def check_decisions(cfg, blocks, bps: int, dev, strict: bool = False) -> None:
    """One batch through the same BatchEncoder on the CPU and on the card
    (the strict host arrays, when strict, given to both): the decisions
    must be equal. This holds the Rice kernel against its plain version on
    the path's real residuals. Launches made here are not counted."""
    import torch

    from flacenc_tpu_torch.ops.windows import get_window
    from flacenc_tpu_torch.models import batch_encoder as tbe

    _, C, T = blocks.shape
    ext = ()
    if strict:
        window = get_window(cfg.subframe_coding.qlpc.window, T)
        ext = tuple(torch.from_numpy(a) for a in tbe._strict_ext_arrays(blocks, cfg, C, bps, window))
    enc = tbe.BatchEncoder(cfg, C, bps, T, strict_lpc=strict)
    x = torch.from_numpy(blocks)
    with torch.inference_mode():
        cpu = enc(x, *ext)
        gpu = enc.to(dev)(x.to(dev), *(a.to(dev) for a in ext)).cpu()
    if not torch.equal(cpu, gpu):
        rows = int((cpu != gpu).any(dim=1).sum())
        raise AssertionError(f"decisions differ between the card and the CPU in {rows} blocks")


def check_lossless(data: bytes, x, bytes_per: int, label: str) -> None:
    """Both decoders give back `x` and the STREAMINFO MD5 is the input's."""
    import numpy as np

    from flacenc_tpu_torch.component import decode_stream, parse_stream
    from flacenc_tpu_torch.native import independent
    from flacenc_tpu_torch.source import samples_to_le_bytes

    stream = parse_stream(data)
    if not np.array_equal(decode_stream(stream).reshape(-1), x):
        raise AssertionError(f"{label}: component decoder: samples differ from the input")
    ind = independent.decode_stream(data)
    if not np.array_equal(ind.samples, x):
        raise AssertionError(f"{label}: independent decoder: samples differ from the input")
    md5 = hashlib.md5(samples_to_le_bytes(x, bytes_per)).digest()
    if stream.stream_info().md5 != md5 or ind.md5 != md5:
        raise AssertionError(f"{label}: STREAMINFO MD5 does not match the input")


class Phases:
    """Runs the encode paths on the card and keeps each one's Rice launches."""

    def __init__(self, dev, card: str):
        self.dev = dev
        self.card = card
        self.launches = {}

    def stream(self, name, cfg, x, channels, bps, rate, *, block_size=4096, strict=None):
        """Drive `encode_with_fixed_block_size` on the card once with the
        launch count reset just before and read just after; returns the
        stream's bytes."""
        import flacenc_tpu_torch
        from flacenc_tpu_torch.source import MemSource
        from flacenc_tpu_torch.ops import rice_tables

        check_decisions(cfg, first_batch(x, channels, block_size), bps, self.dev,
                        strict=bool(strict))
        stats = {}
        rice_tables.launches = 0
        t0 = time.perf_counter()
        stream = flacenc_tpu_torch.encode_with_fixed_block_size(
            cfg, MemSource(x, channels, bps, rate), block_size, device=self.dev,
            stats=stats, strict_lpc=strict,
        )
        wall = time.perf_counter() - t0
        launches = rice_tables.launches
        per_forward = rice_per_forward(cfg, block_size)
        if launches == 0 or launches != per_forward * stats["batches"]:
            raise AssertionError(
                f"{name}: rice_cost_tables launched {launches} times for "
                f"{stats['batches']} batches x {per_forward} per forward"
            )
        data = stream.to_bytes()
        check_lossless(data, x, -(-bps // 8), name)
        self.report(name, len(x) / channels / rate, wall, len(data), x.size,
                    launches, per_forward, stats)
        return data

    def report(self, name, audio_s, wall, nbytes, nvalues, launches, per_forward, stats):
        """One JSON line of the path's numbers, beside the card's name."""
        self.launches[name] = launches
        print(f"{name}: " + json.dumps({
            "audio_s": audio_s, "x_realtime": audio_s / wall, "wall_s": wall,
            "bits_per_sample": 8 * nbytes / nvalues, "bytes": nbytes,
            "rice_launches": launches, "rice_per_forward": per_forward,
            "stats": stats, "card": self.card,
        }))
        print(f"{name}: decoded losslessly by both decoders, MD5 matches, card decisions "
              f"== CPU decisions, launches {launches} == {per_forward} x "
              f"{stats['batches']} batches")


def oracle_equal(dev, label, cfg, x, channels, block_size, strict=False) -> None:
    """The port on the card and the numpy oracle give the same bytes."""
    import flacenc_tpu_torch
    from flacenc_tpu_torch.models import reference_encoder
    from flacenc_tpu_torch.source import MemSource

    got = flacenc_tpu_torch.encode_with_fixed_block_size(
        cfg, MemSource(x, channels, 16, 44100), block_size, device=dev, strict_lpc=strict
    ).to_bytes()
    oracle = reference_encoder.encode_with_fixed_block_size(
        cfg, MemSource(x, channels, 16, 44100), block_size, strict_lpc=strict
    ).to_bytes()
    if got != oracle:
        raise AssertionError(f"{label}: the port's bytes differ from the numpy oracle's")
    n = len(x) // channels
    print(f"oracle: {label} ({n} samples, {-(-n // block_size)} frames) byte-identical, "
          f"sha256 {hashlib.sha256(got).hexdigest()[:16]}")


def corpus_phase(phases: Phases, cfg, workdir: str) -> None:
    """8 WAV files of 30-240 s at 44.1 and 48 kHz through `encode_corpus`
    on the card; each stream equals the file encoded alone."""
    import flacenc_tpu_torch
    from flacenc_tpu_torch.wav import WavFileSource, write_wav
    from flacenc_tpu_torch.ops import rice_tables

    files = [(240, 44100), (30, 48000), (95.5, 44100), (45.25, 48000),
             (120, 44100), (61, 48000), (33.3, 44100), (180, 48000)]
    audio = []
    for i, (sec, rate) in enumerate(files):
        x = tone_audio(sec, seed=100 + i, rate=rate)
        path = os.path.join(workdir, f"track{i:02d}.wav")
        write_wav(path, x, 2, 16, rate)
        audio.append((path, x))
    check_decisions(cfg, first_batch(audio[0][1], 2, 4096), 16, phases.dev)
    sources = [(path, WavFileSource(path)) for path, _ in audio]
    rice_tables.launches = 0
    t0 = time.perf_counter()
    streams, stats = flacenc_tpu_torch.encode_corpus(sources, cfg, 4096, device=phases.dev)
    wall = time.perf_counter() - t0
    launches = rice_tables.launches
    per_forward = rice_per_forward(cfg, 4096)
    if launches == 0 or launches != per_forward * stats.batches:
        raise AssertionError(f"corpus: {launches} launches for {stats.batches} batches")
    nbytes = 0
    for path, x in audio:
        data = streams[path].to_bytes()
        alone = flacenc_tpu_torch.encode_with_fixed_block_size(
            cfg, WavFileSource(path), 4096, device=phases.dev
        ).to_bytes()
        if data != alone:
            raise AssertionError(f"corpus: {path} differs from the file encoded alone")
        check_lossless(data, x, 2, f"corpus {os.path.basename(path)}")
        nbytes += len(data)
    audio_s = sum(x.size / 2 / rate for (_, x), (_, rate) in zip(audio, files))
    phases.report("corpus", audio_s, wall, nbytes, sum(x.size for _, x in audio), launches,
                  per_forward, vars(stats))
    print(f"corpus: {len(files)} files, each stream byte-identical to the file encoded alone")


def cli_phase(phases: Phases, workdir: str, extra_args=()) -> None:
    """`encode` through the port's command line on the card, `decode` back."""
    import numpy as np

    from flacenc_tpu_torch.wav import read_wav, write_wav
    from flacenc_tpu_torch import cli
    from flacenc_tpu_torch.ops import rice_tables

    x = tone_audio(30, seed=7)
    wav = os.path.join(workdir, "cli_in.wav")
    flac = os.path.join(workdir, "cli_out.flac")
    back = os.path.join(workdir, "cli_back.wav")
    write_wav(wav, x, 2, 16, 44100)
    check_decisions(default_config(), first_batch(x, 2, 4096), 16, phases.dev)
    rice_tables.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["encode", wav, "-o", flac, *extra_args])
    wall = time.perf_counter() - t0
    launches = rice_tables.launches
    if rc != 0:
        raise AssertionError(f"cli encode exited {rc}")
    batches = -(-(len(x) // 2 // 4096) // 64)
    per_forward = rice_per_forward(default_config(), 4096)
    if launches != per_forward * batches:
        raise AssertionError(f"cli: {launches} launches for {batches} batches")
    if cli.main(["decode", flac, "-o", back]) != 0:
        raise AssertionError("cli decode failed")
    samples, channels, bps, rate = read_wav(back)
    if (channels, bps, rate) != (2, 16, 44100) or not np.array_equal(samples, x):
        raise AssertionError("cli: the decoded WAV differs from the input")
    with open(flac, "rb") as f:
        data = f.read()
    check_lossless(data, x, 2, "cli")
    phases.report("cli", x.size / 2 / 44100, wall, len(data), x.size, launches, per_forward,
                  {"batches": batches})


def run_paths(phases: Phases, cli_args=()) -> None:
    """Every encode path of the port, through its public entries, on
    `phases.dev`, each checked as the module docstring says."""
    import numpy as np

    import flacenc_tpu_torch
    from flacenc_tpu_torch import config, sigen
    from flacenc_tpu_torch.config import Window
    from flacenc_tpu_torch.source import MemSource

    dev = phases.dev
    default = default_config()
    flacenc_tpu_torch.encode_with_fixed_block_size(  # warm-up: CUDA context, lib load
        default, MemSource(cd_audio(10, seed=1), 2, 16, 44100), 4096, device=dev
    )

    # 4. the main path: 240 s of 16-bit / 44.1 kHz stereo on the card
    phases.stream("main path", default, cd_audio(240, seed=0), 2, 16, 44100)

    # 5. against the numpy oracle: 8 full blocks plus a ragged tail
    oracle_equal(dev, "sigen stereo clip", default, sigen_clip(8 * 4096 + 1234), 2, 4096)

    # 6. fixed-only mono, 16-bit / 44.1 kHz
    fixed_only = config.Encoder()
    fixed_only.subframe_coding.use_lpc = False
    phases.stream("fixed-only mono", fixed_only.into_verified().inner,
                  tone_audio(120, seed=11, channels=1), 1, 16, 44100)

    # 7. hi-res: 24-bit / 96 kHz stereo
    phases.stream("hi-res 24/96", default, tone_audio(60, seed=12, rate=96000, bps=24),
                  2, 24, 96000)

    # 8. experimental: direct MSE, then IRLS with 2 steps
    dmse = config.Encoder()
    dmse.subframe_coding.qlpc.use_direct_mse = True
    phases.stream("direct MSE", dmse.into_verified().inner, cd_audio(30, seed=13), 2, 16, 44100)
    irls = config.Encoder()
    irls.subframe_coding.qlpc.use_direct_mse = True
    irls.subframe_coding.qlpc.mae_optimization_steps = 2
    phases.stream("IRLS 2 steps", irls.into_verified().inner, cd_audio(10, seed=14),
                  2, 16, 44100)
    exp_oracle = config.Encoder()  # the config and signal of tests/test_experimental.py:86
    exp_oracle.subframe_coding.qlpc.use_direct_mse = True
    exp_oracle.subframe_coding.qlpc.window = Window.rectangle()
    n = 1024 * 2 + 100
    clip = np.zeros(2 * n, np.int32)
    clip[0::2] = sigen.Sine(90, 0.4).noise_with_seed(1, 0.01).to_vec_quantized(16, n)
    clip[1::2] = sigen.Sine(91, 0.4).noise_with_seed(2, 0.01).to_vec_quantized(16, n)
    oracle_equal(dev, "direct MSE sigen clip", exp_oracle.into_verified().inner, clip, 2, 1024)

    # 9. BitCount fixed-order selection on CD stereo
    bitcount = config.Encoder()
    bitcount.subframe_coding.fixed.order_sel = config.OrderSel(type="BitCount")
    bitcount = bitcount.into_verified().inner
    phases.stream("BitCount", bitcount, cd_audio(60, seed=15), 2, 16, 44100)
    oracle_equal(dev, "BitCount sigen clip", bitcount, sigen_clip(8 * 4096 + 1234), 2, 4096)

    # 10. strict mode on CD stereo
    phases.stream("strict", default, cd_audio(60, seed=16), 2, 16, 44100, strict=True)
    oracle_equal(dev, "strict sigen clip", default, sigen_clip(8 * 4096 + 2345), 2, 4096,
                 strict=True)

    with tempfile.TemporaryDirectory() as workdir:
        # 11. a corpus of WAV files at two sample rates
        corpus_phase(phases, default, workdir)
        # 12. the command line
        cli_phase(phases, workdir, cli_args)


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="smoke test of the port on one CUDA card")
    parser.add_argument("--kernel-only", action="store_true",
                        help="stop after the kernel checks and times (no encode paths, "
                             "no result line)")
    parser.add_argument("--compare-with", metavar="SOURCE.cu",
                        help="also time the kernel built from another source of "
                             "csrc/rice_tables.cu with the first kernel's C entry, in turns")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; a CUDA card is required",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from flacenc_tpu_torch import config
    from flacenc_tpu_torch.csrc import build as kbuild
    from flacenc_tpu_torch.models import batch_encoder as tbe
    from flacenc_tpu_torch.ops import fixed, rice, rice_tables

    dev = torch.device("cuda", 0)
    card = card_line()
    t_all = time.perf_counter()
    # 1. card
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    fresh = kbuild.is_stale()
    lib = kbuild.build()
    print(f"build: {lib} ({'compiled' if fresh else 'up to date'}) in "
          f"{time.perf_counter() - t0:.3f} s")
    with open(kbuild.PTXAS_LOG) as f:
        print("ptxas: " + " | ".join(
            line.strip() for line in f if "registers" in line or "smem" in line))

    # 3. kernel against plain and its times, and the tie sites
    times = check_kernel(rice_tables, rice.finest_partition_order, dev)
    if args.compare_with:
        compare_with(args.compare_with, dev)
    kernel = {
        "name": "rice_cost_tables",
        "route": "cuda",
        "source": "flacenc_tpu_torch/csrc/rice_tables.cu",
        "replaces": "flacenc_tpu/ops/pallas_rice.py:74",
        "launches": None,
        "max_abs_err": times["max_abs_err"],
        "ms": times["ms"],
        "cold_ms": times["cold_ms"],
        "plain_ms": times["plain_ms"],
        "transpose_ms": times["transpose_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the tables
    }
    if args.kernel_only:
        print(json.dumps({"kernels": [kernel]}))
        return 0
    check_ties(config, tbe, fixed, rice, dev)

    phases = Phases(dev, card)
    run_paths(phases)

    if "jax" in sys.modules or any(m == "flacenc_tpu" or m.startswith("flacenc_tpu.")
                                   for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")
    print(f"all phases passed in {time.perf_counter() - t_all:.1f} s ({card})")
    # 13. kernels, then the result
    kernel.update(launches=phases.launches["main path"], launches_by_path=phases.launches)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
