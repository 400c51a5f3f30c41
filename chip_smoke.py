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
- the command line: encode a WAV on the card, decode it back;
- the residual-shipping packers: packer="native" on 60 s CD stereo and on
  20 s of 24-bit / 96 kHz stereo whose residuals overflow int16 (the host
  recomputes those channels), packer="python" on 10 s CD stereo, each
  stream equal to the default packer's;
- a mesh of two replicas on the card (60 s CD stereo, equal to one
  device's stream), `total_bits_psum` and `dryrun_multichip(2)`;
- the device fuzz tier: 100 default-mode and 25 strict cases at block 512
  against the numpy oracle;
- the upload wires, each forced on 60 s of CD stereo whose content takes
  it ("d" delta16, "w" fixed width, "r" rice, "m" mid/side rice), the rice
  wire on 60 s of 24/96, strict mode under a packed wire, and
  FLACENC_FETCH_GROUP=4 grouped round trips, each stream equal to the raw
  upload's;
- the pipeline's depth: the main path's 240 s at depth 8 (the default,
  FLACENC_PIPELINE_DEPTH) and at depth 2 with equal bytes, each run's wall
  split by ``tools.overlap.analyze``;
- the rice and mid/side wires over a mesh of two replicas, equal to
  `mesh=None`;
- the corpus over two processes on cuda:0 joined by a gloo group, each
  rank's `shard_corpus` share equal to the one-process corpus, the byte
  totals all-gathered;
- the other fuzz tiers: plain (50), mutate (60), upload (25, its coverage
  gate held) and cli (10);
- the report generator (5 s programs) and both examples, the corpus
  example's files equal to the corpus phase's streams;
- the measurement programs: ``tools.bench`` (60 s, 3 trials 1 s apart,
  batch 256, the strict same-corpus encode and the device step; its best
  stream decoded), ``tools.hwconfigs`` (the five BASELINE configs at 30 s,
  1 s gaps, every row without an error) and ``tools.microbench`` at
  --reps 10 with its kernel sweep (the kernel equal to its plain version on
  all 9 shapes), each printing its JSON lines.

Every encode runs through the port's program registry: on the card each
forward is a captured CUDA graph replayed batch after batch (the direct
MSE and IRLS forwards, which sync, run eagerly), and the main path runs the
upload-wire racer. Every path decodes losslessly with two decoders and its
MD5 matches; one batch of its blocks gives the same decisions (on the
residual packers' paths every output, residuals included) on the card as
on the CPU; the Rice kernel's runs, as the card counts them (each run adds
one to a counter in device memory, inside graph replays too), equal what
the config implies for the batch forwards the run made (a capture's eager
warm-up forward counts as one); and at the end
every captured graph's replay equals its module's eager forward on the
same batch. Every failure raises; the script exits 0 only when every phase
passed. Its last line is one JSON object naming the card; the line before
it lists each kernel with its launches on every path and its times.

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
            None, torch.cuda.current_stream().cuda_stream)  # no run counter
        if rc:
            raise RuntimeError(f"transpose kernel launch failed: {rc}")

    transpose()
    if not torch.equal(out, plain()):
        raise AssertionError("the transpose kernel differs from the plain version")

    def uncounted():  # the wrapper's kernel without its run counter: what counting costs
        rc = lib.flacenc_rice_cost_tables_mma(
            e.data_ptr(), w.data_ptr(), out.data_ptr(), 256, 4096, 6, None,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"mma kernel launch failed: {rc}")

    uncounted()
    if not torch.equal(out, plain()):
        raise AssertionError("the mma kernel without a counter differs from the plain version")
    times = {
        "ms": cuda_ms(kernel),
        "cold_ms": cuda_ms_rotating(cold),
        "plain_ms": cuda_ms(plain),
        "transpose_ms": cuda_ms(transpose),
        "uncounted_ms": cuda_ms(uncounted),
    }
    bound = kernel_bound_ms(256, 4096, 6)
    times.update(max_abs_err=max_err, bound_ms=bound, bound_by="bytes",
                 share_warm=bound / times["ms"], share_cold=bound / times["cold_ms"])
    print(f"rice_cost_tables at B*K=256 T=4096 (CUDA graph replay): L2-warm "
          f"{times['ms']} ms, L2-cold {times['cold_ms']} ms, bound {bound} ms (bytes), "
          f"share of bound warm {times['share_warm']} cold {times['share_cold']}; "
          f"plain {times['plain_ms']} ms; the transpose kernel at this shape "
          f"{times['transpose_ms']} ms; without the run counter {times['uncounted_ms']} ms; "
          f"eager with host launch: kernel "
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


class Counts:
    """Rice kernel runs, as the card counts them, and the registry's batch
    forwards since the object was made: the card's counter is set to 0
    here, just before a path runs, and both are read just after it."""

    def __init__(self):
        from flacenc_tpu_torch.models import batch_encoder as tbe
        from flacenc_tpu_torch.ops import rice_tables

        self._tbe, self._rice = tbe, rice_tables
        rice_tables.reset_launches()
        self._forwards = tbe.PROGRAM_COUNTS["forwards"]

    def read(self):
        return self._rice.launches(), self._tbe.PROGRAM_COUNTS["forwards"] - self._forwards


def check_launches(name, launches, forwards, per_forward, batch_forwards) -> None:
    """The card counted `per_forward` Rice kernel runs for every batch
    forward of the run (graph replays, eager forwards, and a capture's
    warm-up), and the run made at least one forward per batch and shard."""
    if launches == 0 or launches != per_forward * forwards or forwards < batch_forwards:
        raise AssertionError(
            f"{name}: rice_cost_tables launched {launches} times in {forwards} forwards "
            f"({per_forward} per forward; {batch_forwards} batch forwards at least)"
        )


def first_batch(x, channels: int, block_size: int, batch: int = 64):
    """The first `batch` full blocks of interleaved `x` as (B, C, T) int32."""
    import numpy as np

    n = min(batch, len(x) // channels // block_size)
    return x[: n * block_size * channels].reshape(n, block_size, channels) \
        .transpose(0, 2, 1).astype(np.int32).copy()


def check_decisions(cfg, blocks, bps: int, dev, strict: bool = False,
                    residuals: bool = False) -> None:
    """One batch through the same BatchEncoder on the CPU and on the card
    (the strict host arrays, when strict, given to both): the decisions
    must be equal, and with `residuals` every `DeviceEncoded` field, the
    int16 residuals and fits16 included. This holds the Rice kernel
    against its plain version on the path's real residuals. Launches made
    here are not counted."""
    import torch

    from flacenc_tpu_torch.ops.windows import get_window
    from flacenc_tpu_torch.models import batch_encoder as tbe

    _, C, T = blocks.shape
    ext = ()
    if strict:
        window = get_window(cfg.subframe_coding.qlpc.window, T)
        ext = tuple(torch.from_numpy(a) for a in tbe._strict_ext_arrays(blocks, cfg, C, bps, window))
    enc = tbe.BatchEncoder(cfg, C, bps, T, strict_lpc=strict, decisions_only=not residuals)
    x = torch.from_numpy(blocks)
    with torch.inference_mode():
        cpu = enc(x, *ext)
        gpu = enc.to(dev)(x.to(dev), *(a.to(dev) for a in ext))
    if residuals:
        for field, a, b in zip(cpu._fields, cpu, gpu):
            if not torch.equal(a, b.cpu()):
                raise AssertionError(f"DeviceEncoded.{field} differs between the card and the CPU")
        return
    gpu = gpu.cpu()
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

    def stream(self, name, cfg, x, channels, bps, rate, *, block_size=4096, strict=None,
               packer="auto", mesh="auto", upload_pack="env", stats=None):
        """Drive `encode_with_fixed_block_size` on the card once with the
        launch count reset just before and read just after; returns the
        stream's bytes (and fills `stats`). A mesh of n replicas runs n
        forwards a batch."""
        import flacenc_tpu_torch
        from flacenc_tpu_torch.models import batch_encoder as tbe
        from flacenc_tpu_torch.source import MemSource

        check_decisions(cfg, first_batch(x, channels, block_size), bps, self.dev,
                        strict=bool(strict), residuals=packer in ("native", "python"))
        stats = {} if stats is None else stats
        counts = Counts()
        t0 = time.perf_counter()
        stream = flacenc_tpu_torch.encode_with_fixed_block_size(
            cfg, MemSource(x, channels, bps, rate), block_size, device=self.dev,
            stats=stats, strict_lpc=strict, packer=packer, mesh=mesh, upload_pack=upload_pack,
        )
        wall = time.perf_counter() - t0
        launches, forwards = counts.read()
        per_forward = rice_per_forward(cfg, block_size)
        shards = max(1, tbe._mesh_device_count(mesh, 64, self.dev))
        check_launches(name, launches, forwards, per_forward, stats["batches"] * shards)
        stats["forwards"] = forwards
        t0 = time.perf_counter()
        data = stream.to_bytes()  # the "python" packer's frames serialize here
        stats["serialize_s"] = time.perf_counter() - t0
        check_lossless(data, x, -(-bps // 8), name)
        self.report(name, len(x) / channels / rate, wall, len(data), x.size,
                    launches, per_forward, stats, shards=shards, packer=packer,
                    download=download_bytes(channels, block_size, 64, tbe.resolve_packer(packer)))
        return data

    def report(self, name, audio_s, wall, nbytes, nvalues, launches, per_forward, stats,
               shards=1, packer="auto", download=None):
        """One JSON line of the path's numbers, beside the card's name."""
        from flacenc_tpu_torch.models import batch_encoder as tbe

        self.launches[name] = launches
        print(f"{name}: " + json.dumps({
            "audio_s": audio_s, "x_realtime": audio_s / wall, "wall_s": wall,
            "bits_per_sample": 8 * nbytes / nvalues, "bytes": nbytes,
            "rice_launches": launches, "rice_per_forward": per_forward, "shards": shards,
            "packer": tbe.resolve_packer(packer), "download_bytes_per_batch": download,
            "stats": {k: v for k, v in stats.items() if k != "timeline"}, "card": self.card,
        }))
        print(f"{name}: decoded losslessly by both decoders, MD5 matches, card decisions "
              f"== CPU decisions, launches {launches} == {per_forward} x "
              f"{stats.get('forwards', stats['batches'] * shards)} forwards "
              f"({stats['batches']} batches x {shards} shards, captures' warm-ups included)")


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


def corpus_phase(phases: Phases, cfg, workdir: str):
    """8 WAV files of 30-240 s at 44.1 and 48 kHz through `encode_corpus`
    on the card; each stream equals the file encoded alone. Returns
    ([(path, samples)], {path: stream bytes})."""
    import flacenc_tpu_torch
    from flacenc_tpu_torch.wav import WavFileSource, write_wav

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
    counts = Counts()
    t0 = time.perf_counter()
    streams, stats = flacenc_tpu_torch.encode_corpus(sources, cfg, 4096, device=phases.dev)
    wall = time.perf_counter() - t0
    launches, forwards = counts.read()
    per_forward = rice_per_forward(cfg, 4096)
    check_launches("corpus", launches, forwards, per_forward, stats.batches)
    nbytes = 0
    encoded = {}
    for path, x in audio:
        data = encoded[path] = streams[path].to_bytes()
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
    return audio, encoded


def cli_phase(phases: Phases, workdir: str, extra_args=()) -> None:
    """`encode` through the port's command line on the card, `decode` back."""
    import numpy as np

    from flacenc_tpu_torch.wav import read_wav, write_wav
    from flacenc_tpu_torch import cli

    x = tone_audio(30, seed=7)
    wav = os.path.join(workdir, "cli_in.wav")
    flac = os.path.join(workdir, "cli_out.flac")
    back = os.path.join(workdir, "cli_back.wav")
    write_wav(wav, x, 2, 16, 44100)
    check_decisions(default_config(), first_batch(x, 2, 4096), 16, phases.dev)
    counts = Counts()
    t0 = time.perf_counter()
    rc = cli.main(["encode", wav, "-o", flac, *extra_args])
    wall = time.perf_counter() - t0
    launches, forwards = counts.read()
    if rc != 0:
        raise AssertionError(f"cli encode exited {rc}")
    batches = -(-(len(x) // 2 // 4096) // 64)
    per_forward = rice_per_forward(default_config(), 4096)
    check_launches("cli", launches, forwards, per_forward, batches)
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


def download_bytes(channels: int, block_size: int, batch: int, packer: str) -> int:
    """Bytes one batch downloads: the (B, F) int32 decisions for "native2";
    for "native" and "python" the decisions plus a fits16 column group and
    the (B, C, T) int16 residuals."""
    from flacenc_tpu_torch import constants
    from flacenc_tpu_torch.ops import rice

    P = 1 << rice.finest_partition_order(block_size, constants.rice.MIN_PARTITION_SIZE)
    F = 1 + channels * (5 + constants.qlpc.MAX_ORDER + P)
    if packer == "native2":
        return batch * F * 4
    return batch * (F + channels) * 4 + batch * channels * block_size * 2


def timed(label: str):
    """Prints the wall time of the `with` block as the phase's time."""
    import contextlib

    @contextlib.contextmanager
    def block():
        t0 = time.perf_counter()
        yield
        print(f"phase {label}: {time.perf_counter() - t0:.2f} s wall")

    return block()


def encode_bytes(dev, cfg, x, channels, bps, rate, **kw) -> bytes:
    """One encode on the card outside the counted runs (a reference)."""
    import flacenc_tpu_torch
    from flacenc_tpu_torch.source import MemSource

    return flacenc_tpu_torch.encode_with_fixed_block_size(
        cfg, MemSource(x, channels, bps, rate), 4096, device=dev, **kw
    ).to_bytes()


def residual_packer_phases(phases: Phases) -> None:
    """a. packer="native" on 60 s CD stereo; b. "native" on 20 s of 24-bit /
    96 kHz stereo noisy enough that residuals overflow int16 (so the host
    recompute runs); c. packer="python" on 10 s CD stereo. Each stream
    equals the "native2" stream of the same audio."""
    import numpy as np

    from flacenc_tpu_torch import sigen
    from flacenc_tpu_torch.models import batch_encoder as tbe

    dev, default = phases.dev, default_config()
    with timed("a (native packer, 60 s CD)"):
        x = cd_audio(60, seed=17)
        got = phases.stream("native packer", default, x, 2, 16, 44100, packer="native")
        if got != encode_bytes(dev, default, x, 2, 16, 44100, packer="native2"):
            raise AssertionError("native packer: bytes differ from native2's")
        print(f"native packer: bytes == native2, download {download_bytes(2, 4096, 64, 'native')} "
              f"B per batch against native2's {download_bytes(2, 4096, 64, 'native2')}")

    with timed("b (native packer, 20 s 24/96 beyond int16)"):
        n = 20 * 96000
        x = np.zeros(2 * n, np.int32)  # the signal of tests/test_packers.py:72
        for ch in range(2):
            x[ch::2] = sigen.Sine(97 + ch, 0.6).noise_with_seed(ch, 0.2).to_vec_quantized(24, n)
        fixed = []
        real = tbe._host_errors

        def counting(enc, signal):
            fixed.append(int(((~enc.fits16) & (enc.sf_type >= tbe.T_FIXED)).sum()))
            return real(enc, signal)

        tbe._host_errors = counting
        try:
            got = phases.stream("native packer 24-bit overflow", default, x, 2, 24, 96000,
                                packer="native")
        finally:
            tbe._host_errors = real
        if not sum(fixed):
            raise AssertionError("24-bit overflow: no channel had fits16 false")
        if got != encode_bytes(dev, default, x, 2, 24, 96000, packer="native2"):
            raise AssertionError("native packer 24-bit overflow: bytes differ from native2's")
        print(f"native packer 24-bit overflow: {sum(fixed)} of {2 * (n // 4096)} stored "
              "channels were predicted with a residual beyond int16 (fits16 false) and "
              "recomputed on the host; bytes == native2")

    with timed("c (python packer, 10 s CD)"):
        x = cd_audio(10, seed=18)
        got = phases.stream("python packer", default, x, 2, 16, 44100, packer="python")
        if got != encode_bytes(dev, default, x, 2, 16, 44100, packer="native2"):
            raise AssertionError("python packer: bytes differ from native2's")
        print("python packer: bytes == native2")


def mesh_phase(phases: Phases) -> None:
    """d. A mesh of two replicas on cuda:0 over 60 s of CD stereo: bytes
    equal one device's; `total_bits_psum` over one batch's shards equals the
    sum of the decisions' sf_bits; `dryrun_multichip(2)`. With more than one
    card, `mesh="auto"` across them too."""
    import torch

    from flacenc_tpu_torch.models import batch_encoder as tbe
    from flacenc_tpu_torch.parallel import mesh as pmesh

    dev, default = phases.dev, default_config()
    with timed("d (mesh of two replicas, 60 s CD)"):
        x = cd_audio(60, seed=19)
        m = pmesh.block_mesh([dev, dev])
        got = phases.stream("mesh 2 replicas", default, x, 2, 16, 44100, mesh=m)
        if got != encode_bytes(dev, default, x, 2, 16, 44100, mesh=None):
            raise AssertionError("mesh: bytes differ from mesh=None")
        blocks = torch.from_numpy(first_batch(x, 2, 4096))
        with torch.inference_mode():
            enc = tbe.BatchEncoder(default, 2, 16, 4096, decisions_only=False)
            pinned = blocks.pin_memory() if dev.type == "cuda" else blocks
            shards = pmesh.shard_encoder_fn(enc, m).launch(pinned)
            total = int(pmesh.total_bits_psum([o.sf_bits for _, o in shards], m))
            dec = tbe.split_decisions(
                tbe.BatchEncoder(default, 2, 16, 4096).to(dev)(blocks.to(dev)).cpu().numpy(), 2)
        if total != int(dec.sf_bits.sum()):
            raise AssertionError(f"total_bits_psum {total} != decisions' {int(dec.sf_bits.sum())}")
        print(f"mesh: bytes == mesh=None; total_bits_psum {total} == sum of sf_bits")
        pmesh.dryrun_multichip(2, device=dev.type)
        n_cards = torch.cuda.device_count()
        print(f"torch.cuda.device_count() = {n_cards}")
        if n_cards > 1:
            phases.stream("mesh auto", default, x, 2, 16, 44100, mesh="auto")


def fuzz_phase(phases: Phases, default_cases: int = 100, strict_cases: int = 25) -> dict:
    """e. The device fuzz tier on the card at block 512: a default-tier run
    (divergences must resolve in strict mode) and a strict-tier run (every
    case byte-equal to the oracle)."""
    from flacenc_tpu_torch import fuzz
    from flacenc_tpu_torch.ops import rice_tables

    out = {}
    with timed(f"e (device fuzz, {default_cases} default + {strict_cases} strict cases)"):
        rice_tables.reset_launches()
        for strict, n in ((False, default_cases), (True, strict_cases)):
            r = fuzz.run(range(n), strict=strict, device=phases.dev)
            seeds = [d["seed"] for d in r["divergences"]]
            if strict and seeds:
                raise AssertionError(f"strict fuzz diverged at seeds {seeds}")
            out["strict" if strict else "default"] = r
            print(f"fuzz {'strict' if strict else 'default'} tier: {r['cases']} cases in "
                  f"{r['seconds']:.2f} s, {len(seeds)} divergences (each resolved by strict "
                  f"mode), seeds {seeds}")
        launches = rice_tables.launches()
        if launches == 0:
            raise AssertionError("fuzz: the Rice kernel was never launched")
        phases.launches["fuzz"] = launches
    return out


def walk_audio(seconds: int, seed: int):
    """Interleaved 16-bit stereo random walks (uniform steps in [-127, 127]):
    deltas spread evenly over 8 bits, where the fixed-width wire beats rice."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = seconds * 44100
    x = np.empty(2 * n, np.int32)
    for ch in range(2):
        walk = np.cumsum(rng.integers(-127, 128, n)) + 30000
        # reflected off +-30000, so every step keeps its size
        x[ch::2] = np.abs(walk % 120000 - 60000) - 30000
    return x


def smooth_audio(seconds: int, seed: int):
    """Interleaved 16-bit stereo of independent random walks with steps in
    [-40, 40]: small first differences, so the rice wire wins."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(seconds * 44100)
    x = np.empty(2 * n, np.int32)
    for ch in range(2):
        x[ch::2] = np.clip(np.cumsum(rng.integers(-40, 41, n)), -30000, 30000)
    return x


def correlated_audio(seconds: int, seed: int):
    """Interleaved 16-bit stereo whose right channel is the left plus noise
    of +-30: the side plane is small, so the mid/side wire wins."""
    import numpy as np

    rng = np.random.default_rng(seed)
    left = tone_audio(seconds, seed, channels=1)
    x = np.empty(2 * left.size, np.int32)
    x[0::2] = left
    x[1::2] = np.clip(left + rng.integers(-30, 31, left.size), -32768, 32767)
    return x


def wire_kinds(stats) -> set:
    """The upload wire kinds a run's batches took (None for raw PCM)."""
    import ast

    return {None if k == "None" else ast.literal_eval(k)[0] for k in stats["wire_batches"]}


def wire_phases(phases: Phases) -> None:
    """f. Each upload wire forced on 60 s of CD stereo whose content takes
    it; g. the rice wire on 60 s of 24/96; h. strict mode under a packed
    wire; i. FLACENC_FETCH_GROUP=4. Each stream equals the raw upload's."""
    dev, default = phases.dev, default_config()
    cases = [
        ("f", "wire d (delta16)", cd_audio(60, seed=30), 16, 44100, "delta", "d", None),
        ("f", "wire w (fixed width)", walk_audio(60, seed=31), 16, 44100, True, "w", None),
        ("f", "wire r (rice)", cd_audio(60, seed=20), 16, 44100, True, "r", None),
        ("f", "wire m (mid/side rice)", correlated_audio(60, seed=33), 16, 44100, True, "m",
         None),
        ("g", "wire r 24/96", tone_audio(60, seed=34, rate=96000, bps=24), 24, 96000, True, "r",
         None),
        ("h", "strict + packed wire", cd_audio(60, seed=24), 16, 44100, True, "r", True),
    ]
    for label, name, x, bps, rate, up, kind, strict in cases:
        with timed(f"{label} ({name}, 60 s)"):
            stats = {}
            got = phases.stream(name, default, x, 2, bps, rate, strict=strict, upload_pack=up,
                                stats=stats)
            if wire_kinds(stats) != {kind}:
                raise AssertionError(f"{name}: batches took wires {stats['wire_batches']}")
            raw = encode_bytes(dev, default, x, 2, bps, rate, upload_pack=False,
                               strict_lpc=strict)
            if got != raw:
                raise AssertionError(f"{name}: bytes differ from the raw upload's")
            print(f"{name}: every batch on {kind}, bytes == raw upload "
                  f"({stats['wire_batches']})")
    with timed("i (FLACENC_FETCH_GROUP=4, 60 s CD)"):
        x = cd_audio(60, seed=36)
        os.environ["FLACENC_FETCH_GROUP"] = "4"
        try:
            stats = {}
            got = phases.stream("grouped G=4", default, x, 2, 16, 44100, upload_pack=False,
                                stats=stats)
        finally:
            os.environ["FLACENC_FETCH_GROUP"] = "1"
        if stats["grouped_batches"] != stats["batches"]:
            raise AssertionError(f"grouped: {stats['grouped_batches']} of {stats['batches']} "
                                 "batches went through groups")
        if got != encode_bytes(dev, default, x, 2, 16, 44100, upload_pack=False):
            raise AssertionError("grouped: bytes differ from one batch per round trip")
        print(f"grouped G=4: {stats['grouped_batches']} batches in groups, bytes == ungrouped")
        del os.environ["FLACENC_FETCH_GROUP"]


def depth_phase(phases: Phases, x) -> dict:
    """j. The main path's audio at depth 8 (the default) and at depth 2,
    with the stage timeline on: equal bytes; each run's x-realtime,
    max_inflight, `tools.overlap.analyze` split of the wall, submit_s,
    pack_s and device_wait_s."""
    from flacenc_tpu_torch import constants
    from flacenc_tpu_torch.tools import overlap

    default = default_config()
    saved = constants.par.FRAMEBUF_MULTIPLICITY
    os.environ["FLACENC_TIMELINE"] = "1"
    out, data = {}, {}
    try:
        for depth in (8, 2):
            constants.par.FRAMEBUF_MULTIPLICITY = depth
            with timed(f"j (depth {depth}, 240 s CD)"):
                stats = {}
                data[depth] = phases.stream(f"depth {depth}", default, x, 2, 16, 44100,
                                            stats=stats)
            if stats["max_inflight"] != min(depth, stats["batches"]):
                raise AssertionError(f"depth {depth}: max_inflight {stats['max_inflight']}")
            audio_s = len(x) / 2 / 44100
            out[depth] = {
                "x_realtime": audio_s / stats["wall_s"], "wall_s": stats["wall_s"],
                "max_inflight": stats["max_inflight"], "batches": stats["batches"],
                "submit_s": stats["submit_s"], "pack_s": stats["pack_s"],
                "device_wait_s": stats["device_wait_s"], "read_s": stats["read_s"],
                "wire_batches": stats["wire_batches"],
                "overlap": overlap.analyze(stats["timeline"], stats["wall_s"]),
            }
            print(f"depth {depth}: " + json.dumps(out[depth]) + f" ({phases.card})")
    finally:
        constants.par.FRAMEBUF_MULTIPLICITY = saved
        del os.environ["FLACENC_TIMELINE"]
    if data[8] != data[2]:
        raise AssertionError("depth 8 and depth 2 give different bytes")
    print("depth 8 vs depth 2: bytes equal; x-realtime "
          f"{out[8]['x_realtime']} vs {out[2]['x_realtime']} ({phases.card})")
    return out


def mesh_wire_phase(phases: Phases) -> None:
    """k. The rice and mid/side wires forced over a mesh of two replicas on
    the card (30 s CD stereo each): bytes equal `mesh=None`'s, every batch
    on the wire."""
    from flacenc_tpu_torch.parallel import mesh as pmesh

    dev, default = phases.dev, default_config()
    m = pmesh.block_mesh([dev, dev])
    for kind, x in (("r", smooth_audio(30, seed=40)), ("m", correlated_audio(30, seed=41))):
        with timed(f"k (mesh 2 replicas, wire {kind}, 30 s)"):
            stats = {}
            got = phases.stream(f"mesh wire {kind}", default, x, 2, 16, 44100, mesh=m,
                                upload_pack=True, stats=stats)
            if wire_kinds(stats) != {kind}:
                raise AssertionError(f"mesh wire {kind}: batches took {stats['wire_batches']}")
            if got != encode_bytes(dev, default, x, 2, 16, 44100, mesh=None, upload_pack=True):
                raise AssertionError(f"mesh wire {kind}: bytes differ from mesh=None")
            print(f"mesh wire {kind}: every batch on {kind} over 2 replicas, bytes == mesh=None")


def dcn_child(rank: int, port: int, out_dir: str, paths, device: str = "cuda:0") -> None:
    """One rank of the multi-process corpus: join a gloo group of two,
    encode this rank's `shard_corpus` share on `device`, write each stream
    to `out_dir`, all_gather the byte totals and write this rank's summary."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from flacenc_tpu_torch.models import batch_encoder as tbe
    from flacenc_tpu_torch.parallel import encode_corpus, shard_corpus
    from flacenc_tpu_torch.wav import WavFileSource

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    try:
        dev = torch.device(device)
        mine = shard_corpus(list(paths), 2, rank)
        counts = Counts()
        streams, stats = encode_corpus([(p, WavFileSource(p)) for p in mine], default_config(),
                                       4096, device=dev)
        launches, forwards = counts.read()
        total = 0
        for i, path in enumerate(mine):
            data = streams[path].to_bytes()
            total += len(data)
            with open(os.path.join(out_dir, os.path.basename(path) + ".flac"), "wb") as f:
                f.write(data)
        local = torch.tensor([total], dtype=torch.int64)
        gathered = [torch.zeros_like(local) for _ in range(2)]
        dist.all_gather(gathered, local)
        summary = {
            "rank": rank, "files": mine, "bytes": total,
            "gathered": [int(t.item()) for t in gathered], "launches": launches,
            "forwards": forwards, "batches": stats.batches,
            "auto_mesh": tbe._mesh_device_count("auto", 64, dev),
            "jax_modules": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                                  or m == "flacenc_tpu" or m.startswith("flacenc_tpu.")),
        }
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(summary, f)
    finally:
        dist.destroy_process_group()


def dcn_phase(phases: Phases, audio, encoded, workdir: str) -> None:
    """l. The 8-WAV corpus split by `shard_corpus` over two processes on
    cuda:0, joined by a gloo group: each rank's streams equal the
    one-process corpus's (each rank's shortest is decoded with both
    decoders again and its MD5 checked); both ranks gathered the same byte
    totals; `mesh="auto"` gave no mesh."""
    import socket

    out_dir = os.path.join(workdir, "dcn")
    os.makedirs(out_dir)
    paths = [path for path, _ in audio]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    with timed("l (two processes on cuda:0, 8-WAV corpus)"):
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dcn-rank", str(rank), "--dcn-port",
             str(port), "--dcn-out", out_dir, *paths], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(2)]
        try:
            logs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        if any(p.returncode for p in procs):
            raise AssertionError("dcn: a rank failed:\n" + "\n---\n".join(
                log[-3000:] for log in logs))
        ranks = []
        for rank in range(2):
            with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
                ranks.append(json.load(f))
        samples = dict(audio)
        seen, launches, forwards, batches = [], 0, 0, 0
        for r in ranks:
            if r["jax_modules"] or r["auto_mesh"] != 0:
                raise AssertionError(f"dcn rank {r['rank']}: {r}")
            for path in r["files"]:
                with open(os.path.join(out_dir, os.path.basename(path) + ".flac"), "rb") as f:
                    data = f.read()
                if data != encoded[path]:
                    raise AssertionError(f"dcn: {path} differs from the one-process corpus")
                if path == min(r["files"], key=lambda p: samples[p].size):
                    # the others equal streams the corpus phase decoded
                    check_lossless(data, samples[path], 2, f"dcn {os.path.basename(path)}")
                seen.append(path)
            launches += r["launches"]
            forwards += r["forwards"]
            batches += r["batches"]
        if sorted(seen) != sorted(paths):
            raise AssertionError(f"dcn: the ranks covered {seen}")
        totals = [r["bytes"] for r in ranks]
        if any(r["gathered"] != totals for r in ranks):
            raise AssertionError(f"dcn: gathered totals {[r['gathered'] for r in ranks]}")
        check_launches("dcn", launches, forwards, rice_per_forward(default_config(), 4096),
                       batches)
        phases.launches["dcn"] = launches
        print("dcn: " + json.dumps({
            "ranks": 2, "files": [len(r["files"]) for r in ranks], "bytes": totals,
            "gathered": ranks[0]["gathered"], "batches": batches, "rice_launches": launches,
            "forwards": forwards, "wall_s": wall, "card": phases.card,
        }))
        print("dcn: every rank's streams == the one-process corpus; each rank's shortest "
              "decoded by both decoders, MD5 matches; both ranks gathered the same totals")


def fuzz_tier_phase(phases: Phases) -> dict:
    """m. The other fuzz tiers: plain (50, the numpy oracle on the host),
    mutate (60, the parser), upload (25 on the card, coverage gate held)
    and cli (10 on the card). The Rice kernel must run in the card's tiers."""
    from flacenc_tpu_torch import fuzz
    from flacenc_tpu_torch.ops import rice_tables

    out = {}
    for tier, n in (("plain", 50), ("mutate", 60), ("upload", 25), ("cli", 10)):
        with timed(f"m (fuzz {tier} tier, {n} cases)"):
            rice_tables.reset_launches()
            r = fuzz.run(range(n), device=phases.dev, tier=tier)
            launches = rice_tables.launches()
            if tier in ("upload", "cli"):
                if launches == 0:
                    raise AssertionError(f"fuzz {tier}: the Rice kernel was never launched")
                phases.launches[f"fuzz {tier}"] = launches
            out[tier] = r
            print(f"fuzz {tier} tier: {r['cases']} cases in {r['seconds']:.2f} s, Rice "
                  f"launches {launches}" + (f", wires covered {r['formats_seen']}"
                                            if tier == "upload" else ""))
    return out


def tools_phase(phases: Phases, audio, encoded, workdir: str) -> None:
    """n. The report generator at --seconds 5 into a temporary file (it
    decodes every stream it makes), the library example (it decodes its
    stream; here both decoders and the MD5 check it too), and the corpus
    example over the 8 WAVs (its files equal the corpus phase's streams;
    the shortest is decoded again)."""
    import numpy as np

    from flacenc_tpu_torch import sigen
    from flacenc_tpu_torch.component import parse_stream
    from flacenc_tpu_torch.examples import corpus_encode, encode_library
    from flacenc_tpu_torch.tools import reporter

    default = default_config()
    with timed("n (reporter, --seconds 5)"):
        counts = Counts()
        report = os.path.join(workdir, "report.md")
        if reporter.main(["--seconds", "5", "-o", report]) != 0:
            raise AssertionError("reporter failed")
        launches, forwards = counts.read()
        if launches == 0:
            raise AssertionError("reporter: the Rice kernel was never launched")
        phases.launches["reporter"] = launches
        with open(report) as f:
            text = f.read()
        if phases.card.split(",")[0] not in text:
            raise AssertionError("reporter: the backend line does not name the card")
        print("reporter: " + " | ".join(line for line in text.splitlines()
                                         if line.startswith(("Backend", "| "))))
    with timed("n (examples)"):
        counts = Counts()
        data = encode_library.main(device=phases.dev)
        launches, forwards = counts.read()
        check_launches("example library", launches, forwards, rice_per_forward(default, 4096), 1)
        phases.launches["example library"] = launches
        n = 88200  # the example's PCM, rebuilt from its seeds
        pcm = np.zeros(2 * n, np.int32)
        pcm[0::2] = sigen.Sine(100, 0.5).noise_with_seed(1, 0.01).to_vec_quantized(16, n)
        pcm[1::2] = sigen.Sine(101, 0.5).noise_with_seed(2, 0.01).to_vec_quantized(16, n)
        check_lossless(data, pcm, 2, "example library")
        info = parse_stream(data).stream_info()
        print(f"example library: {len(data)} bytes, {info.total_samples} samples, MD5 "
              f"{info.md5.hex()}, Rice launches {launches}")
        out_dir = os.path.join(workdir, "example_corpus")
        counts = Counts()
        stats = corpus_encode.main([path for path, _ in audio], out_dir, device=phases.dev)
        launches, forwards = counts.read()
        check_launches("example corpus", launches, forwards, rice_per_forward(default, 4096),
                       stats.batches)
        phases.launches["example corpus"] = launches
        samples = dict(audio)
        shortest = min(encoded, key=lambda p: samples[p].size)
        for path in encoded:
            name = os.path.splitext(os.path.basename(path))[0] + ".flac"
            with open(os.path.join(out_dir, name), "rb") as f:
                got = f.read()
            if got != encoded[path]:
                raise AssertionError(f"example corpus: {name} differs from the corpus phase's")
            if path == shortest:  # the others equal streams the corpus phase decoded
                check_lossless(got, samples[path], 2, f"example corpus {name}")
        print(f"example corpus: {stats.files} files == the corpus phase's streams, the "
              f"shortest decoded by both decoders, MD5 matches; max_inflight_batches "
              f"{stats.max_inflight_batches}, Rice launches {launches}")


def graph_checks(dev) -> dict:
    """Every captured program of the registry: its capture's check (the
    first replay equal to the eager warm-up) held, and one more replay on
    the batch in its static inputs equals its module's eager forward on
    them, and the card counts the Rice kernel runs of one replay. Then the
    main path's raw program: host ms of one replay call (the inputs' copy
    and the replay enqueued) against one eager forward's enqueue, and
    device ms of a replay. Launches made here are not counted."""
    import statistics

    import torch

    from flacenc_tpu_torch.models import batch_encoder as tbe
    from flacenc_tpu_torch.ops import rice_tables

    progs = [p for p in tbe._PROGRAMS.values() if p.capture]
    keys = []
    with torch.inference_mode():
        for p in progs:
            if not p.checked:
                raise AssertionError(f"capture check failed for {p.key[5:]}")
            rice_tables.reset_launches()
            p.graph.replay()
            rice_per_replay = rice_tables.launches()
            if rice_per_replay != p.batches * rice_per_forward(p.module.cfg, p.key[3]):
                raise AssertionError(f"{p.key[5:]}: {rice_per_replay} Rice runs in one replay")
            replayed = p.static_out
            replayed = (replayed.clone() if isinstance(replayed, torch.Tensor)
                        else tuple(t.clone() for t in replayed))
            eager = p.module(*p.static_in)
            if not tbe._outputs_equal(replayed, eager):
                raise AssertionError(f"graph replay != eager forward for {p.key[5:]}")
            keys.append({"packer": p.key[5], "wire": p.key[6], "shapes": p.key[7],
                         "replica": p.key[9], "grouped": p.key[10],
                         "rice_per_replay": rice_per_replay})
    torch.cuda.synchronize(dev)
    print(f"graphs: {len(progs)} captured keys, each replay == its eager forward on one batch "
          f"({len(tbe._PROGRAMS) - len(progs)} eager keys): " + json.dumps(keys, default=str))

    main = [p for p in progs if p.key[:4] == (default_config().to_toml(), 2, 16, 4096)
            and p.key[5:7] == ("native2", None) and p.key[7][0][0][0] == 64
            and not (p.key[4] or p.key[9] or p.key[10])]
    if not main:
        raise AssertionError("the main path's raw program was not captured")
    prog = main[0]
    host_in = [x.cpu().pin_memory() for x in prog.static_in]
    replay_ms, eager_ms_, device_ms = [], [], []
    with torch.inference_mode():
        for _ in range(20):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            prog(*host_in)
            replay_ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            prog.module(*prog.static_in)
            eager_ms_.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize(dev)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            prog.graph.replay()
            end.record()
            end.synchronize()
            device_ms.append(start.elapsed_time(end))
    out = {"replay_host_ms": statistics.median(replay_ms),
           "eager_host_ms": statistics.median(eager_ms_),
           "replay_device_ms": statistics.median(device_ms),
           "captures": len(progs), "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
    print("graph vs eager at (64, 2, 4096), default config, median of 20: " + json.dumps(out)
          + f" ({card_line()})")
    return out


def captured(main, argv) -> tuple:
    """Runs a tool's `main(argv)` and echoes its standard output; returns
    (its exit code, the JSON objects it printed one to a line)."""
    import contextlib
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    finally:
        sys.stdout.write(buf.getvalue())
        sys.stdout.flush()
    return rc, [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]


def measurement_phase(phases: Phases) -> None:
    """o. The port's measurement programs on the card: the bench at 60 s,
    3 trials 1 s apart, batch 256 (its best trial's stream decoded by both
    decoders with its MD5 checked; 2 Rice runs for every forward of the whole
    run, the device step's included); the five-config matrix at 30 s with 1 s
    gaps (every row without an error; 1 or 2 Rice runs a forward); the
    microbenchmark at --reps 10 and its kernel sweep (the kernel equal to its
    plain version on all 9 shapes)."""
    from flacenc_tpu_torch.tools import bench, hwconfigs, make_audio, microbench

    env = {"BENCH_SECONDS": "60", "BENCH_WARM_SECONDS": "20", "BENCH_TRIALS": "3",
           "BENCH_TRIAL_GAP_S": "1", "BENCH_BATCH": "256"}
    saved = {key: os.environ.get(key) for key in env}
    with timed("o (bench: 60 s, 3 trials, batch 256)"):
        os.environ.update(env)
        try:
            counts = Counts()
            extra, data = bench.main_worker(phases.dev)
            launches, forwards = counts.read()
        finally:
            for key, value in saved.items():
                if value is None:
                    del os.environ[key]
                else:
                    os.environ[key] = value
        check_launches("bench", launches, forwards, rice_per_forward(default_config(), 4096),
                       extra["batches"])
        audio = make_audio(60)
        check_lossless(data, audio, 2, "bench")
        if extra["card"] != phases.card or extra["device_step_batch"] != 256:
            raise AssertionError(f"bench: {extra}")
        if extra["bits_per_sample"] != round(len(data) * 8 / len(audio), 4):
            raise AssertionError("bench: bits_per_sample is not its stream's")
        phases.launches["bench"] = launches
        print(f"bench: best trial decoded by both decoders, MD5 matches, launches {launches} == "
              f"2 x {forwards} forwards; trials {extra['trials_x_realtime']}, device step "
              f"{extra['device_step_ms_per_batch']} ms at batch 256 ({phases.card})")

    with tempfile.TemporaryDirectory() as workdir, timed("o (hwconfigs --seconds 30 --gap 1)"):
        table = os.path.join(workdir, "hwconfigs.md")
        counts = Counts()
        rc, rows = captured(hwconfigs.main, ["--seconds", "30", "--gap", "1", "--out", table])
        launches, forwards = counts.read()
        if rc or len(rows) != 5 or any("error" in r for r in rows):
            raise AssertionError(f"hwconfigs: exit {rc}, rows {rows}")
        # the fixed-only forwards run one Rice search, the others two
        if not 0 < forwards <= launches <= 2 * forwards:
            raise AssertionError(f"hwconfigs: {launches} Rice runs in {forwards} forwards")
        with open(table) as f:
            text = f.read()
        if phases.card not in text:
            raise AssertionError("hwconfigs: the table does not name the card")
        phases.launches["hwconfigs"] = launches
        print("hwconfigs: " + " | ".join(line for line in text.splitlines()
                                          if line.startswith(("Backend", "| "))))

    with timed("o (microbench --reps 10, then --kernel-sweep)"):
        counts = Counts()
        rc, _ = captured(microbench.main, ["--reps", "10"])
        rc_sweep, sweep_lines = captured(microbench.main, ["--kernel-sweep", "--reps", "10"])
        launches, _ = counts.read()
        sweep = sweep_lines[-1]["sweep"]
        if rc or rc_sweep or len(sweep) != 9 or any(r["max_abs_err"] for r in sweep):
            raise AssertionError(f"microbench: exit {rc} / {rc_sweep}, sweep {sweep}")
        if launches == 0:
            raise AssertionError("microbench: the Rice kernel was never launched")
        phases.launches["microbench"] = launches
        print(f"microbench: kernel == plain on all {len(sweep)} sweep shapes ({phases.card})")


def run_paths(phases: Phases, cli_args=()) -> None:
    """Every encode path of the port, through its public entries, on
    `phases.dev`, each checked as the module docstring says."""
    import numpy as np
    import torch

    import flacenc_tpu_torch
    from flacenc_tpu_torch import config, sigen
    from flacenc_tpu_torch.config import Window
    from flacenc_tpu_torch.source import MemSource

    dev = phases.dev
    default = default_config()
    flacenc_tpu_torch.encode_with_fixed_block_size(  # warm-up: CUDA context, lib load
        default, MemSource(cd_audio(10, seed=1), 2, 16, 44100), 4096, device=dev
    )

    # 4. the main path: 240 s of 16-bit / 44.1 kHz stereo on the card, the
    # upload-wire racer on, every forward a graph replay
    torch.cuda.reset_peak_memory_stats(dev)
    stats = {}
    phases.stream("main path", default, cd_audio(240, seed=0), 2, 16, 44100, stats=stats)
    print(f"main path: wire_counts {stats['wire_batches']}, grouped_batches "
          f"{stats['grouped_batches']}, captures {stats['captures']} in {stats['capture_s']} s, "
          f"peak device memory {torch.cuda.max_memory_allocated(dev)} B ({phases.card})")
    # the same audio again, every program the racer visits already captured
    stats = {}
    phases.stream("main path, warm registry", default, cd_audio(240, seed=0), 2, 16, 44100,
                  stats=stats)
    print(f"main path, warm registry: wire_counts {stats['wire_batches']}, captures "
          f"{stats['captures']}")
    # the same audio at depth 8 and at depth 2, the stage timeline on
    depth_phase(phases, cd_audio(240, seed=0))

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
        # 11. a corpus of WAV files at two sample rates, then the same
        # corpus over two processes, and the tools and examples
        audio, encoded = corpus_phase(phases, default, workdir)
        dcn_phase(phases, audio, encoded, workdir)
        tools_phase(phases, audio, encoded, workdir)
        # 12. the command line
        cli_phase(phases, workdir, cli_args)

    # 13. the residual-shipping packers, the mesh (raw and packed wires) and
    # the fuzz tiers
    residual_packer_phases(phases)
    mesh_phase(phases)
    mesh_wire_phase(phases)
    fuzz_phase(phases)
    fuzz_tier_phase(phases)

    # 14. the upload wires and grouped round trips, then every graph
    wire_phases(phases)
    phases.graphs = graph_checks(dev)

    # 15. the measurement programs (after the graph checks: their batch-256
    # programs would push the main path's out of the registry)
    measurement_phase(phases)


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
    # one rank of the multi-process corpus phase (the script starts two)
    parser.add_argument("--dcn-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--dcn-port", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--dcn-out", help=argparse.SUPPRESS)
    parser.add_argument("paths", nargs="*", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; a CUDA card is required",
              file=sys.stderr)
        return 1
    if args.dcn_rank is not None:
        dcn_child(args.dcn_rank, args.dcn_port, args.dcn_out, args.paths)
        return 0
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
        "uncounted_ms": times["uncounted_ms"],
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
    # 16. kernels, then the result
    kernel.update(launches=phases.launches["main path"], launches_by_path=phases.launches)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
