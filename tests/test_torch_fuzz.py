"""The port's device fuzz tier (``flacenc_tpu_torch.fuzz``) on the CPU: its
signal generator and canned configs equal the JAX harness's, a few seeds of
each tier pass, and a default-mode divergence is reported with its seed
only when strict mode resolves it, never passed silently."""

import copy
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "fuzz"))

import run_fuzz  # noqa: E402

from flacenc_tpu_torch import fuzz  # noqa: E402


@pytest.mark.parametrize("seed", range(6))
def test_random_signal_gen_equals_jax_harness(seed):
    got = fuzz.random_signal_gen(np.random.default_rng(seed)).to_vec_quantized(16, 3000)
    exp = run_fuzz.random_signal_gen(np.random.default_rng(seed)).to_vec_quantized(16, 3000)
    assert np.array_equal(got, exp)


def test_device_configs_equal_jax_harness():
    got = [c.to_dict() for c in fuzz._device_configs()]
    exp = [c.to_dict() for c in run_fuzz._device_configs()]
    assert got == exp and len(got) == 5


@pytest.mark.parametrize("strict", [False, True])
def test_tier_seeds_pass_on_cpu(strict):
    # seed 630 diverged on the JAX package (a 1-ulp autocorrelation tie)
    seeds = list(range(8)) + [630]
    out = fuzz.run(seeds, strict=strict, device="cpu", log=lambda *a: None)
    assert out["cases"] == len(seeds) and out["strict"] is strict
    for div in out["divergences"]:
        assert div["strict_equal"] and div["seed"] in seeds


def test_divergence_is_reported_and_resolved(monkeypatch):
    """A default-mode byte difference (here forced by a lower LPC order on
    the device side) is reported with its seed once it verifies, decodes
    losslessly and strict mode gives equal bytes."""
    real = fuzz.be.encode_with_fixed_block_size

    def lower_order(cfg, src, block_size, strict_lpc=False, **kw):
        if not strict_lpc:
            cfg = copy.deepcopy(cfg.inner)
            cfg.subframe_coding.qlpc.lpc_order -= 1
        return real(cfg, src, block_size, strict_lpc=strict_lpc, **kw)

    monkeypatch.setattr(fuzz.be, "encode_with_fixed_block_size", lower_order)
    logs = []
    out = fuzz.run(range(20), device="cpu", log=logs.append)
    assert out["divergences"], "no case chose an LPC subframe"
    assert [d["seed"] for d in out["divergences"]] == [
        int(line.split("'seed': ")[1].split(",")[0]) for line in logs
    ]


def test_strict_mismatch_raises_with_its_seed(monkeypatch):
    real = fuzz.re.encode_with_fixed_block_size

    def other_oracle(cfg, src, block_size, strict_lpc=False):
        cfg = copy.deepcopy(cfg.inner)
        cfg.subframe_coding.use_lpc = False
        return real(cfg, src, block_size, strict_lpc=strict_lpc)

    monkeypatch.setattr(fuzz.re, "encode_with_fixed_block_size", other_oracle)
    logs = []
    with pytest.raises(AssertionError, match=r"strict device/oracle stream mismatch") as exc:
        fuzz.run(range(20), strict=True, device="cpu", log=logs.append)
    seed = str(exc.value).split("seed=")[1].rstrip(")")
    assert logs == [f"FUZZ FAILURE at seed={seed}; replay: python -m flacenc_tpu_torch.fuzz "
                    f"--device --strict --seed {seed} --block-size 512"]


def test_cli_runs_seeds(capsys):
    assert fuzz.main(["--device", "--cpu-only", "--iters", "3", "--start", "10"]) == 0
    assert "3 cases passed (default tier, cpu)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        fuzz.main(["--iters", "1"])  # the device tier is the one ported


def test_seed_117_block_4096_diverges_like_jax_and_strict_resolves():
    """Found on the card (block 4096, BitCount config, mono, 17,920
    samples): the default-mode stream is 5,768 bytes against the oracle's
    5,926. The JAX package's program gives the same bytes, so this is the
    shared default-mode estimation deviation; strict mode resolves it."""
    from flacenc_tpu import source
    from flacenc_tpu.models import batch_encoder as jbe

    div = fuzz.one_device_case(117, block_size=4096, device="cpu")
    assert div == {"seed": 117, "config": 2, "channels": 1, "len": 17920,
                   "device_bytes": 5768, "oracle_bytes": 5926, "strict_equal": True}
    rng = np.random.default_rng(117)
    assert not rng.integers(0, 2)  # mono
    n = int(rng.integers(1, 5 * 4096))
    x = run_fuzz.random_signal_gen(rng).to_vec_quantized(16, n)
    jax_bytes = jbe.encode_with_fixed_block_size(
        run_fuzz._device_configs()[2].into_verified(), source.MemSource(x, 1, 16, 44100), 4096,
        batch_size=8,
    ).to_bytes()
    port_bytes = fuzz.be.encode_with_fixed_block_size(
        fuzz._device_configs()[2].into_verified(), fuzz.source.MemSource(x, 1, 16, 44100), 4096,
        batch_size=8, device="cpu",
    ).to_bytes()
    assert port_bytes == jax_bytes and len(jax_bytes) == 5768
