"""Card-only checks of the port: the CUDA Rice kernels (tensor-core and
transpose) against their plain PyTorch version, and the whole device
program on CUDA against the CPU on
every path (mono, stereo, 24-bit, fixed-only, BitCount, strict, direct MSE
and IRLS).

Every test here carries the `gpu` marker and skips without a card. This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flacenc_tpu_torch import config, sigen  # noqa: E402
from flacenc_tpu_torch.source import MemSource  # noqa: E402
from flacenc_tpu_torch.models import reference_encoder  # noqa: E402
from flacenc_tpu_torch.ops.windows import get_window  # noqa: E402

import flacenc_tpu_torch  # noqa: E402
from flacenc_tpu_torch.models import batch_encoder as tbe  # noqa: E402
from flacenc_tpu_torch.ops import rice, rice_tables  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kernel_vs_plain(errors, warmup, device):
    finest = rice.finest_partition_order(errors.shape[-1], 64)
    e = torch.from_numpy(errors).to(device)
    w = torch.from_numpy(warmup).to(device)
    before = rice_tables.launches
    got = rice_tables.rice_cost_tables(e, w, finest)
    torch.cuda.synchronize()
    assert rice_tables.launches == before + 1
    assert torch.equal(got, rice_tables.rice_cost_tables_plain(e, w, finest))


@pytest.mark.parametrize("T", [1024, 4096, 16384, 4095, 32767, 32])
def test_kernel_matches_plain(cuda, T):
    rng = np.random.default_rng(T)
    errors = rng.integers(-(1 << 20), 1 << 20, (8, 4, T)).astype(np.int32)
    warmup = rng.integers(0, 25, (8, 4)).astype(np.int32)
    _kernel_vs_plain(errors, warmup, cuda)


def test_unaligned_input_takes_the_transpose_kernel(cuda):
    rng = np.random.default_rng(3)
    errors = rng.integers(-(1 << 20), 1 << 20, (4, 4, 4096)).astype(np.int32)
    warmup = rng.integers(0, 25, (4, 4)).astype(np.int32)
    flat = torch.empty(errors.size + 1, dtype=torch.int32, device=cuda)
    e = flat[1:].view(errors.shape)  # 4 bytes past an aligned start
    e.copy_(torch.from_numpy(errors))
    w = torch.from_numpy(warmup).to(cuda)
    assert rice_tables.launch_plan(4096, 6, e.data_ptr()).kernel == "transpose"
    got = rice_tables.rice_cost_tables(e, w, 6)
    torch.cuda.synchronize()
    assert torch.equal(got, rice_tables.rice_cost_tables_plain(e, w, 6))


def test_kernel_saturation_and_int32_limits(cuda):
    errors = np.zeros((3, 1, 1024), np.int32)
    errors[0, 0, :2] = [(1 << 30) + 1, -((1 << 30) + 2)]
    errors[0, 0, 70] = np.iinfo(np.int32).min
    errors[1, 0, :8] = -(1 << 27)
    errors[2, 0] = np.random.default_rng(0).integers(
        np.iinfo(np.int32).min, np.iinfo(np.int32).max, 1024
    )
    _kernel_vs_plain(errors, np.array([[0], [0], [24]], np.int32), cuda)


def _bitcount(c):
    c.subframe_coding.fixed.order_sel = config.OrderSel(type="BitCount")


def _fixed_only(c):
    c.subframe_coding.use_lpc = False


def _direct_mse(steps):
    def edit(c):
        c.subframe_coding.qlpc.use_direct_mse = True
        c.subframe_coding.qlpc.mae_optimization_steps = steps
    return edit


@pytest.mark.parametrize("C,bps,edit,strict", [
    (1, 16, None, False), (2, 16, None, False), (2, 24, None, False),
    (1, 16, _fixed_only, False), (2, 16, _bitcount, False), (2, 16, None, True),
    (2, 16, _direct_mse(0), False), (2, 16, _direct_mse(2), False),
], ids=["mono", "stereo", "stereo24", "mono_fixed_only", "bitcount", "strict",
        "direct_mse", "irls"])
def test_decisions_match_cpu(cuda, C, bps, edit, strict):
    n = 8 * 1024
    chans = [
        sigen.Sine(128 + 9 * c, 0.4).noise_with_seed(c + 1, 0.01).to_vec_quantized(bps, n)
        for c in range(C)
    ]
    blocks = np.stack(chans).reshape(C, 8, 1024).transpose(1, 0, 2).copy().astype(np.int32)
    cfg = config.Encoder()
    if edit is not None:
        edit(cfg)
    ext = ()
    if strict:
        window = get_window(cfg.subframe_coding.qlpc.window, 1024)
        ext = tuple(map(torch.from_numpy, tbe._strict_ext_arrays(blocks, cfg, C, bps, window)))
    enc = tbe.BatchEncoder(cfg, C, bps, 1024, strict_lpc=strict)
    x = torch.from_numpy(blocks)
    cpu = enc(x, *ext)
    gpu = enc.to(cuda)(x.to(cuda), *(a.to(cuda) for a in ext)).cpu()
    assert torch.equal(cpu, gpu)


def test_stream_matches_oracle(cuda):
    n = 8 * 4096 + 1234
    x = np.zeros(2 * n, np.int32)
    x[0::2] = sigen.Sine(128, 0.4).noise_with_seed(1, 0.01).to_vec_quantized(16, n)
    x[1::2] = sigen.Sine(130, 0.4).noise_with_seed(2, 0.01).to_vec_quantized(16, n)
    cfg = config.Encoder().into_verified()
    got = flacenc_tpu_torch.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 4096, device="cuda"
    ).to_bytes()
    oracle = reference_encoder.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 4096
    ).to_bytes()
    assert got == oracle


def test_strict_stream_and_corpus_on_card(cuda):
    """Strict bytes equal the oracle's strict bytes; a corpus stream equals
    the file encoded alone, on the card."""
    n = 8 * 4096 + 1234
    x = np.zeros(2 * n, np.int32)
    x[0::2] = sigen.Sine(128, 0.4).noise_with_seed(1, 0.01).to_vec_quantized(16, n)
    x[1::2] = sigen.Sine(130, 0.4).noise_with_seed(2, 0.01).to_vec_quantized(16, n)
    cfg = config.Encoder().into_verified()
    got = flacenc_tpu_torch.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 4096, device="cuda", strict_lpc=True
    ).to_bytes()
    assert got == reference_encoder.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 4096, strict_lpc=True
    ).to_bytes()
    streams, _ = flacenc_tpu_torch.encode_corpus(
        [("a", MemSource(x, 2, 16, 44100)), ("b", MemSource(x[: 2 * 5000], 2, 16, 48000))],
        cfg, 4096, batch_size=8, device="cuda",
    )
    assert streams["a"].to_bytes() == flacenc_tpu_torch.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 4096, device="cuda"
    ).to_bytes()
