"""Device fuzz tier of the port (counterpart of ``fuzz/run_fuzz.py --device``).

Each case draws a random 16-bit signal (mono or stereo, 1 .. 5 blocks long)
and one of five canned configs from its seed, encodes it through the
port's `encode_with_fixed_block_size` on the given device, and holds the
stream against the port's numpy oracle (``models/reference_encoder.py``):

- strict tier (`strict=True`, the default config): the bytes must be equal;
- default tier: the bytes are equal except where a float estimate (LPC
  coefficients, the ApproxEnt entropy) lands on a rounding tie, the
  documented default-mode deviation. A case whose bytes differ must still
  verify and decode losslessly, stay within a small size tolerance, and
  give equal bytes in strict mode on the same input. It is reported as a
  divergence with its seed.

Any other outcome raises. Run:

    python -m flacenc_tpu_torch.fuzz --device [--strict] [--iters N]
        [--start S] [--seed S] [--block-size 512] [--cpu-only]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np

from . import config, sigen, source
from .component import decode_stream, parse_stream
from .component.verify import verify_stream
from .models import batch_encoder as be
from .models import reference_encoder as re


def random_signal_gen(rng: np.random.Generator) -> sigen.Signal:
    """Compositional random signal (fuzz_targets/frame_encode.rs:72-126)."""
    kind = rng.integers(0, 4)
    period = int(rng.integers(2, 3000))
    amp = float(rng.uniform(0.01, 0.99))
    if kind == 0:
        base = sigen.Dc(float(rng.uniform(-0.9, 0.9)))
    elif kind == 1:
        base = sigen.Sine(period, amp, float(rng.uniform(0, 6.28)))
    elif kind == 2:
        base = sigen.Square(period, amp)
    else:
        base = sigen.Noise(amp, seed0=int(rng.integers(0, 2**32)))
    for _ in range(int(rng.integers(0, 3))):
        deco = rng.integers(0, 3)
        if deco == 0:
            base = base.noise_with_seed(int(rng.integers(0, 2**32)), float(rng.uniform(0, 0.3)))
        elif deco == 1:
            base = base.clip()
        else:
            base = base.concat(
                int(rng.integers(1, 1000)),
                sigen.Noise(float(rng.uniform(0, 0.5)), seed0=int(rng.integers(0, 2**32))),
            )
    return base


def _device_configs() -> List[config.Encoder]:
    """The five canned configs of the default tier, picked by seed % 5."""
    cfgs = [config.Encoder()]
    c = config.Encoder(); c.subframe_coding.use_lpc = False; cfgs.append(c)
    c = config.Encoder(); c.subframe_coding.fixed.order_sel = config.OrderSel.bit_count(); cfgs.append(c)
    c = config.Encoder(); c.subframe_coding.qlpc.window = config.Window.rectangle(); c.subframe_coding.qlpc.lpc_order = 4; cfgs.append(c)
    c = config.Encoder(); c.stereo_coding.use_midside = False; c.subframe_coding.prc.max_parameter = 20; cfgs.append(c)
    return cfgs


def one_device_case(seed: int, block_size: int = 512, strict: bool = False,
                    device="cuda") -> Optional[dict]:
    """One case of the tier (see the module docstring). Returns None when
    the device and oracle bytes are equal, a dict naming the divergence
    (seed, config index, both sizes) when a default-mode case diverged on
    an estimation tie that strict mode resolves; raises otherwise."""
    rng = np.random.default_rng(seed)
    cfg_index = 0 if strict else seed % 5
    cfg = _device_configs()[cfg_index].into_verified()
    channels = 2 if rng.integers(0, 2) else 1
    signal_len = int(rng.integers(1, 5 * block_size))
    bps = 16
    interleaved = np.zeros(signal_len * channels, dtype=np.int32)
    for ch in range(channels):
        interleaved[ch::channels] = random_signal_gen(rng).to_vec_quantized(bps, signal_len)

    def src():
        return source.MemSource(interleaved, channels, bps, 44100)

    def both(strict_lpc: bool):
        dev = be.encode_with_fixed_block_size(
            cfg, src(), block_size, batch_size=8, device=device, strict_lpc=strict_lpc,
        )
        ref = re.encode_with_fixed_block_size(cfg, src(), block_size, strict_lpc=strict_lpc)
        return dev, dev.to_bytes(), ref.to_bytes()

    stream_d, d, r = both(strict)
    if not np.array_equal(decode_stream(parse_stream(d)), interleaved):
        raise AssertionError(f"device stream does not decode to the input (seed={seed})")
    if d == r:
        return None
    if strict:
        raise AssertionError(f"strict device/oracle stream mismatch (seed={seed})")
    # default mode: a divergence is acceptable only as the documented
    # float-estimation tie
    verify_stream(stream_d)
    if abs(len(d) - len(r)) > max(64, len(r) // 16):
        raise AssertionError(f"size divergence too large (seed={seed}): {len(d)} vs {len(r)}")
    _, ds, rs = both(True)
    if ds != rs:
        raise AssertionError(
            f"divergence not resolved by strict mode (seed={seed}): a real "
            "device/oracle fault, not an estimation tie"
        )
    return {"seed": seed, "config": cfg_index, "channels": channels,
            "len": signal_len, "device_bytes": len(d), "oracle_bytes": len(r),
            "strict_equal": True}


def run(seeds, strict: bool = False, block_size: int = 512, device="cuda",
        log=print) -> dict:
    """Runs `one_device_case` over `seeds`; returns {"cases", "strict",
    "divergences" (the dicts of the diverged cases), "seconds"}. A failing
    case raises after `log` names its seed and replay command."""
    t0 = time.perf_counter()
    divergences = []
    n = 0
    for seed in seeds:
        try:
            div = one_device_case(seed, block_size, strict, device)
        except Exception:
            flag = " --strict" if strict else ""
            log(f"FUZZ FAILURE at seed={seed}; replay: python -m flacenc_tpu_torch.fuzz "
                f"--device{flag} --seed {seed} --block-size {block_size}")
            raise
        n += 1
        if div is not None:
            log(f"default-mode divergence, resolved by strict mode: {div}")
            divergences.append(div)
    return {"cases": n, "strict": strict, "divergences": divergences,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m flacenc_tpu_torch.fuzz", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", action="store_true", required=True,
                    help="the device tier: the port's batched encoder against the oracle")
    ap.add_argument("--strict", action="store_true",
                    help="strict-float QLPC in both encoders (bytes must be equal)")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--seed", type=int, default=None, help="replay one case")
    ap.add_argument("--block-size", type=int, default=512)
    ap.add_argument("--cpu-only", action="store_true", help="run on the CPU, not on cuda")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu_only else "cuda"
    seeds = [args.seed] if args.seed is not None else range(args.start, args.start + args.iters)
    out = run(seeds, args.strict, args.block_size, device)
    print(f"{out['cases']} cases passed ({'strict' if args.strict else 'default'} tier, "
          f"{device}), {len(out['divergences'])} default-mode divergences: "
          f"{[d['seed'] for d in out['divergences']]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
