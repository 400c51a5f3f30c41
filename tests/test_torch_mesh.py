"""The port's batch-axis mesh (``flacenc_tpu_torch.parallel.mesh``) on CPU
replicas: a mesh that repeats the CPU device splits every batch into
shards, one module replica each, as the JAX package's tests split over
virtual CPU devices. Streams must be byte-identical to `mesh=None` and to
the JAX package's; the bit total equals the plain sum."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flacenc_tpu import config, sigen  # noqa: E402
from flacenc_tpu.component import decode_stream, parse_stream  # noqa: E402
from flacenc_tpu.models import batch_encoder as jbe  # noqa: E402
from flacenc_tpu.parallel.mesh import shard_corpus as jshard_corpus  # noqa: E402
from flacenc_tpu.source import MemSource  # noqa: E402

import flacenc_tpu_torch  # noqa: E402
from flacenc_tpu_torch import config as tconfig  # noqa: E402
from flacenc_tpu_torch.models import batch_encoder as tbe  # noqa: E402
from flacenc_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from flacenc_tpu_torch.source import MemSource as TMemSource  # noqa: E402


def _stereo(seed, n):
    x = np.zeros(2 * n, np.int32)
    x[0::2] = sigen.Sine(90 + seed, 0.4).noise_with_seed(seed, 0.02).to_vec_quantized(16, n)
    x[1::2] = sigen.Sine(91 + seed, 0.4).noise_with_seed(seed + 100, 0.02).to_vec_quantized(16, n)
    return x


def _cpu_mesh(n):
    return pmesh.block_mesh(["cpu"] * n)


def _encode(x, block, batch, mesh, packer="auto"):
    return flacenc_tpu_torch.encode_with_fixed_block_size(
        tconfig.Encoder(), TMemSource(x, 2, 16, 44100), block, batch_size=batch,
        device="cpu", mesh=mesh, packer=packer,
    ).to_bytes()


@pytest.mark.parametrize("packer", ["native2", "native"])
@pytest.mark.parametrize("n_dev", [2, 4])
def test_mesh_bytes_equal_one_device_and_jax(n_dev, packer):
    x = _stereo(7, 512 * 17 + 99)  # 3 batches of 8, the last padded, and a tail
    got = _encode(x, 512, 8, _cpu_mesh(n_dev), packer)
    assert got == _encode(x, 512, 8, None, packer)
    jax_bytes = jbe.encode_with_fixed_block_size(
        config.Encoder().into_verified(), MemSource(x, 2, 16, 44100), 512, batch_size=8,
        mesh=None,
    ).to_bytes()
    assert got == jax_bytes
    assert np.array_equal(decode_stream(parse_stream(got)), x)


@pytest.mark.parametrize("n_dev", [2, 4, 6])
def test_short_stream_clamp_respects_mesh_size(n_dev):
    """A 3-full-block stream clamps batch 64 to 8, rounded up to a multiple
    of the mesh size (12 on 6 replicas), so the split never fails; bytes
    equal the unsplit encode (tests/test_parallel.py's case)."""
    n = 512 * 3 + 100
    x = _stereo(21, n)
    seen = []
    real = pmesh.ShardedEncoder.launch

    def spy(self, *inputs):
        seen.append(inputs[0].shape[0])
        return real(self, *inputs)

    pmesh.ShardedEncoder.launch = spy
    try:
        got = _encode(x, 512, 64, _cpu_mesh(n_dev))
    finally:
        pmesh.ShardedEncoder.launch = real
    assert seen == [-(-8 // n_dev) * n_dev]
    assert got == _encode(x, 512, 64, None)
    assert np.array_equal(decode_stream(parse_stream(got)), x)


def test_explicit_mesh_must_divide_the_batch():
    with pytest.raises(ValueError, match="split evenly"):
        _encode(_stereo(3, 512 * 20), 512, 8, _cpu_mesh(3))


@pytest.mark.parametrize("kind", ["decisions", "encoded", "wire"])
def test_sharded_module_returns_what_one_device_returns(kind):
    rng = np.random.default_rng(1)
    blocks = torch.from_numpy(rng.integers(-(1 << 12), 1 << 12, (8, 2, 256), dtype=np.int32))
    kw = {"decisions": {}, "encoded": {"decisions_only": False},
          "wire": {"wire_encoded": True}}[kind]
    enc = tbe.BatchEncoder(tconfig.Encoder(), 2, 16, 256, **kw)
    one = enc(blocks)
    split = pmesh.shard_encoder_fn(enc, _cpu_mesh(4))
    assert len(split.replicas) == 4 and all(r is not enc for r in split.replicas)
    got = split(blocks)
    if kind == "decisions":
        assert torch.equal(got, one)
    else:
        assert type(got) is type(one) and len(got) == len(one)
        for g, o in zip(got, one):
            assert torch.equal(g, o)


def test_total_bits_psum_equals_plain_sum():
    rng = np.random.default_rng(2)
    blocks = torch.from_numpy(rng.integers(-(1 << 12), 1 << 12, (8, 2, 256), dtype=np.int32))
    enc = tbe.BatchEncoder(tconfig.Encoder(), 2, 16, 256, decisions_only=False)
    m = _cpu_mesh(4)
    shards = pmesh.shard_encoder_fn(enc, m).launch(blocks)
    sf_bits = enc(blocks).sf_bits
    plain = int(sf_bits.sum())
    assert int(pmesh.total_bits_psum(sf_bits, m)) == plain
    assert int(pmesh.total_bits_psum([out.sf_bits for _, out in shards], m)) == plain
    with pytest.raises(ValueError):
        pmesh.total_bits_psum(sf_bits[:6], m)


def test_shard_corpus_equals_jax():
    paths = [f"f{i}" for i in range(10)]
    for n_hosts in (1, 3, 4):
        for h in range(n_hosts):
            assert pmesh.shard_corpus(paths, n_hosts, h) == jshard_corpus(paths, n_hosts, h)
    with pytest.raises(ValueError):
        pmesh.shard_corpus(paths, 3, 3)


def test_dryrun_multichip_on_cpu(capsys):
    out = pmesh.dryrun_multichip(2, device="cpu")
    assert out["devices"] == ["cpu", "cpu"] and out["batch"] == 4 and out["total_bits"] > 0
    assert "dryrun_multichip OK" in capsys.readouterr().out


def test_mesh_arguments():
    cpu = torch.device("cpu")
    assert tbe._mesh_device_count(None, 64, cpu) == 0
    assert tbe._mesh_device_count("auto", 64, cpu) == 0  # auto engages only on cards
    assert tbe._auto_mesh("auto", 64, cpu) is None
    m = _cpu_mesh(2)
    assert tbe._mesh_device_count(m, 64, cpu) == 2 and tbe._auto_mesh(m, 64, cpu) is m
    assert m.axis_names == ("blocks",) and m.size == 2
    with pytest.raises(ValueError, match="mesh"):
        tbe._mesh_device_count("all", 64, cpu)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pmesh.block_mesh()
        with pytest.raises(RuntimeError, match="cuda"):
            pmesh.block_mesh(["cuda"])


def test_corpus_over_a_mesh():
    srcs = [(f"f{i}", _stereo(30 + i, n)) for i, n in enumerate([512 * 9 + 5, 512 * 4, 300])]
    cfg = tconfig.Encoder()
    got, _ = flacenc_tpu_torch.encode_corpus(
        [(name, TMemSource(x, 2, 16, 44100)) for name, x in srcs], cfg, 512, batch_size=8,
        device="cpu", mesh=_cpu_mesh(2), packer="python",
    )
    for name, x in srcs:
        assert got[name].to_bytes() == _encode(x, 512, 8, None)
