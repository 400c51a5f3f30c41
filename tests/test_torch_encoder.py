"""Port parity for the whole slice: `BatchEncoder` against the JAX
package's decisions program, and the port's stream encoder against
`flacenc_tpu`'s and the numpy oracle's streams, byte for byte."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")


from flacenc_tpu import config, sigen  # noqa: E402
from flacenc_tpu.component import decode_stream, parse_stream  # noqa: E402
from flacenc_tpu.errors import Verified  # noqa: E402
from flacenc_tpu.models import batch_encoder as jbe  # noqa: E402
from flacenc_tpu.models import reference_encoder  # noqa: E402
from flacenc_tpu.native import independent  # noqa: E402
from flacenc_tpu.source import MemSource  # noqa: E402

import flacenc_tpu  # noqa: E402
import flacenc_tpu_torch  # noqa: E402
from flacenc_tpu_torch import config as tconfig  # noqa: E402
from flacenc_tpu_torch.models import batch_encoder as tbe  # noqa: E402
from flacenc_tpu_torch.source import MemSource as TMemSource  # noqa: E402

T = 1024
B = 8


def _port(cfg):
    """The port's copy of a JAX-package config, verified if it was."""
    if isinstance(cfg, Verified):
        return tconfig.Encoder.from_dict(cfg.inner.to_dict()).into_verified()
    return tconfig.Encoder.from_dict(cfg.to_dict())


def _sigen_blocks(C, bps, n_blocks=B, block=T):
    n = n_blocks * block
    chans = [
        sigen.Sine(128 + 9 * c, 0.4).noise_with_seed(c + 1, 0.01).to_vec_quantized(bps, n)
        for c in range(C)
    ]
    return np.stack(chans).reshape(C, n_blocks, block).transpose(1, 0, 2).copy().astype(np.int32)


def _decisions_both(cfg, blocks, bps):
    B_, C, T_ = blocks.shape
    exp = np.asarray(jbe._cached_encoder_fn(
        cfg.to_toml(), C, bps, T_, False, True
    )(blocks))
    got = tbe.BatchEncoder(_port(cfg), C, bps, T_)(torch.from_numpy(blocks))
    assert got.dtype == torch.int32
    return got.numpy(), exp


@pytest.mark.parametrize("bps", [8, 16, 24])
@pytest.mark.parametrize("C", [1, 2])
def test_decisions_match_jax_on_sigen(C, bps):
    cfg = config.Encoder()
    blocks = _sigen_blocks(C, bps)
    if C == 2 and bps == 16:
        blocks[0] = 1234  # constant block: both channels constant
        blocks[1, 0] = -5  # one constant channel
    got, exp = _decisions_both(cfg, blocks, bps)
    assert got.shape == exp.shape and np.array_equal(got, exp)
    dec = tbe.split_decisions(got, C)
    if C == 2 and bps == 16:
        assert np.all(dec.sf_type[0] == tbe.T_CONSTANT)
    # every subframe kind the slice chooses between appears
    assert {tbe.T_LPC} <= set(np.unique(dec.sf_type).tolist())


def test_stereo_mode_tie_takes_first():
    """L == R makes S constant and M == L, so LS, RS and MS cost the same:
    the first minimum (LS, code 1) must win, as in the reference."""
    cfg = config.Encoder()
    blocks = _sigen_blocks(2, 16)
    blocks[:, 1] = blocks[:, 0]
    got, exp = _decisions_both(cfg, blocks, 16)
    assert np.array_equal(got, exp)
    assert np.all(tbe.split_decisions(got, 2).assign == 1)


def test_fixed_order_tie_takes_lowest_order():
    """Seed 300 gives block 29 whose order-0 and order-1 ApproxEnt costs tie
    (216 + 16 * order): the lowest order must win. LPC is off so the fixed
    choice reaches the decisions."""
    cfg = config.Encoder()
    cfg.subframe_coding.use_lpc = False
    blocks = np.random.default_rng(300).integers(-3, 4, (32, 1, 64)).astype(np.int32)
    got, exp = _decisions_both(cfg, blocks, 16)
    assert np.array_equal(got, exp)
    dec = tbe.split_decisions(got, 1)
    assert dec.sf_type[29, 0] == tbe.T_FIXED and dec.order[29, 0] == 0


def test_split_decisions_roundtrip():
    blocks = _sigen_blocks(2, 16)
    enc = tbe.BatchEncoder(tconfig.Encoder(), 2, 16, T)(torch.from_numpy(blocks)).numpy()
    dec = tbe.split_decisions(enc, 2)
    jdec = jbe.split_decisions(enc, 2)
    for name in dec._fields:
        assert np.array_equal(getattr(dec, name), getattr(jdec, name)), name
    with pytest.raises(ValueError):
        tbe.split_decisions(enc[:, :-1], 2)


@pytest.mark.parametrize("variant", [
    {"decisions_only": False}, {"wire_encoded": True},
    {"packed_wire": ("d", 2)}, {"grouped": 4},
])
def test_unported_variants_raise(variant):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tbe.BatchEncoder(tconfig.Encoder(), 2, 16, T, **variant)


def _set(path, value):
    def apply(cfg):
        *head, last = path.split(".")
        obj = cfg
        for name in head:
            obj = getattr(obj, name)
        setattr(obj, last, value)
    return apply


# config branches of the device program, each held against JAX: subframe
# types and stereo modes turned off, low fixed orders, BitCount, 3-8
# channels, and block sizes from the too-short path (< 64) to 32767
_BRANCHES = {
    "bitcount": ([_set("subframe_coding.fixed.order_sel", config.OrderSel(type="BitCount"))], 2, 1024, 4),
    "bitcount_max_order_2": ([_set("subframe_coding.fixed.order_sel", config.OrderSel(type="BitCount")),
                              _set("subframe_coding.fixed.max_order", 2)], 1, 1024, 4),
    "no_fixed": ([_set("subframe_coding.use_fixed", False)], 2, 1024, 4),
    "no_lpc": ([_set("subframe_coding.use_lpc", False)], 2, 1024, 4),
    "no_constant": ([_set("subframe_coding.use_constant", False)], 2, 1024, 4),
    "no_ls_ms": ([_set("stereo_coding.use_leftside", False),
                  _set("stereo_coding.use_midside", False)], 2, 1024, 4),
    "no_stereo_modes": ([_set("stereo_coding.use_leftside", False),
                         _set("stereo_coding.use_rightside", False),
                         _set("stereo_coding.use_midside", False)], 2, 1024, 4),
    "fixed_max_order_0": ([_set("subframe_coding.fixed.max_order", 0)], 1, 1024, 4),
    "fixed_max_order_3_no_lpc": ([_set("subframe_coding.fixed.max_order", 3),
                                  _set("subframe_coding.use_lpc", False)], 1, 1024, 4),
    "3_channels": ([], 3, 1024, 4),
    "8_channels": ([], 8, 256, 2),
    "block_32_too_short": ([], 2, 32, 8),
    "block_63_too_short": ([], 1, 63, 8),
    "block_64": ([], 2, 64, 8),
    "block_4095": ([], 2, 4095, 2),
    "block_32767": ([], 1, 32767, 2),
}


@pytest.mark.parametrize("branch", list(_BRANCHES))
def test_config_branch_decisions_match_jax(branch):
    edits, C, T_, B_ = _BRANCHES[branch]
    cfg = config.Encoder()
    for edit in edits:
        edit(cfg)
    cfg = cfg.into_verified().inner
    blocks = _sigen_blocks(C, 16, n_blocks=B_, block=T_)
    if T_ == 1024:
        # a constant channel. Its (unused) LPC coefficients come from a
        # near-singular solve and may differ in the last float64 bits
        # between XLA and torch; at this size they quantize alike.
        blocks[0, 0] = 77
    got, exp = _decisions_both(cfg, blocks, 16)
    assert got.shape == exp.shape and np.array_equal(got, exp)
    dec = tbe.split_decisions(got, C)
    kinds = set(np.unique(dec.sf_type).tolist())
    sub = cfg.subframe_coding
    if T_ < 64:
        assert kinds <= {tbe.T_CONSTANT, tbe.T_VERBATIM}
    if not sub.use_lpc or T_ < 64:
        assert tbe.T_LPC not in kinds
    if not sub.use_fixed:
        assert tbe.T_FIXED not in kinds
    if not sub.use_constant:
        assert tbe.T_CONSTANT not in kinds
    assert np.all(dec.order[dec.sf_type == tbe.T_FIXED] <= sub.fixed.max_order)
    if C == 2:
        st = cfg.stereo_coding
        allowed = {0} | {code for flag, code in ((st.use_leftside, 1), (st.use_rightside, 2),
                                                 (st.use_midside, 3)) if flag}
        assert set(dec.assign.tolist()) <= allowed


def test_bitcount_launches_a_rice_search_per_order():
    """BitCount runs a full Rice search for every fixed order plus one for
    LPC: the Rice table wrapper is called max_order + 2 times per forward."""
    from flacenc_tpu_torch.ops import rice_tables

    cfg = tconfig.Encoder()
    cfg.subframe_coding.fixed.order_sel = tconfig.OrderSel(type="BitCount")
    calls = []
    plain = rice_tables.rice_cost_tables_plain
    try:
        rice_tables.rice_cost_tables_plain = lambda *a: calls.append(1) or plain(*a)
        tbe.BatchEncoder(cfg, 2, 16, T)(torch.from_numpy(_sigen_blocks(2, 16, n_blocks=2)))
    finally:
        rice_tables.rice_cost_tables_plain = plain
    assert len(calls) == cfg.subframe_coding.fixed.max_order + 2


def _stereo(n, bps=16):
    x = np.zeros(2 * n, np.int32)
    x[0::2] = sigen.Sine(128, 0.4).noise_with_seed(1, 0.01).to_vec_quantized(bps, n)
    x[1::2] = sigen.Sine(130, 0.4).noise_with_seed(2, 0.01).to_vec_quantized(bps, n)
    return x


@pytest.mark.parametrize("n_samples,batch_size", [
    (T * 9 + 333, 4),  # two full batches, a padded one and a ragged tail
    (T * 3 + 100, 64),  # shorter than one batch: the clamp to 8
    (500, 64),  # only a ragged tail
])
def test_stream_bytes_match_jax_and_oracle(n_samples, batch_size):
    x = _stereo(n_samples)
    cfg = config.Encoder().into_verified()
    stats = {}
    got = flacenc_tpu_torch.encode_with_fixed_block_size(
        _port(cfg), TMemSource(x, 2, 16, 44100), T, batch_size=batch_size, device="cpu",
        stats=stats,
    ).to_bytes()
    jax_bytes = flacenc_tpu.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), T, batch_size=batch_size
    ).to_bytes()
    oracle = reference_encoder.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), T
    ).to_bytes()
    assert got == jax_bytes == oracle
    assert np.array_equal(decode_stream(parse_stream(got)), x)
    ind = independent.decode_stream(got)
    assert np.array_equal(ind.samples, x)
    full = n_samples // T
    assert stats["frames"] == full + (n_samples % T > 0)
    assert stats["batches"] == -(-full // min(batch_size, max(8, full)))
    assert set(stats) == {"read_s", "submit_s", "device_wait_s", "pack_s",
                          "batches", "frames", "wall_s"}


def test_stream_mono_24bit_per_block_source_matches_oracle():
    """A source without the bulk read goes through the per-block path."""

    class NoBulk(TMemSource):
        def read_blocks_batch(self, n_blocks, block_size, context):
            return None

    n = T * 5 + 7
    x = sigen.Sine(100, 0.5).noise_with_seed(5, 0.02).to_vec_quantized(24, n)
    cfg = config.Encoder().into_verified()
    got = flacenc_tpu_torch.encode_with_fixed_block_size(
        _port(cfg), NoBulk(x, 1, 24, 96000), T, batch_size=2, device="cpu"
    ).to_bytes()
    oracle = reference_encoder.encode_with_fixed_block_size(
        cfg, MemSource(x, 1, 24, 96000), T
    ).to_bytes()
    assert got == oracle


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        flacenc_tpu_torch.encode_with_fixed_block_size(
            tconfig.Encoder(), TMemSource(_stereo(T), 2, 16, 44100), T
        )
