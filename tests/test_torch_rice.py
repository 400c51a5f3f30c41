"""Port parity: the Rice cost-table kernel's plain twin and the Rice search
(flacenc_tpu_torch.ops.{rice_tables,rice}) against the JAX package.

The Pallas kernel runs in interpret mode on the CPU, as tests/test_pallas.py
runs it; the port runs with CPU tensors, which take the plain PyTorch path.
The CUDA kernel itself is held against the plain version by
tests/test_torch_gpu.py (skipped without a card) and by chip_smoke.py."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402  (the repository root is on sys.path: tests/conftest.py)
from flacenc_tpu.ops import pallas_rice  # noqa: E402
from flacenc_tpu.ops import rice as jrice  # noqa: E402
from flacenc_tpu_torch.ops import rice as trice  # noqa: E402
from flacenc_tpu_torch.ops import rice_tables  # noqa: E402


def _errors(seed, B, K, T, lo=-3000, hi=3000):
    rng = np.random.default_rng(seed)
    errors = rng.integers(lo, hi, (B, K, T)).astype(np.int32)
    warmup = rng.integers(0, 25, (B, K)).astype(np.int32)
    return errors, warmup


_jax_search = jax.jit(jrice.find_partitioned_rice_parameters, static_argnums=(2, 3))


@jax.jit
def _jax_finest_tables(errors, warmup):
    T = errors.shape[-1]
    finest = jrice.finest_partition_order(T, 64)
    return jrice._finest_tables(jrice.encode_signbit(errors), warmup, finest, T)


def _jax_tables(errors, warmup, T):
    return np.asarray(_jax_finest_tables(jnp.asarray(errors), jnp.asarray(warmup)))


@pytest.mark.parametrize("T", [1024, 4096])
def test_plain_tables_match_pallas_and_xla(T):
    errors, warmup = _errors(0, 4, 4, T)
    warmup[0, :] = [0, 1, 23, 24]  # the warmup range's ends
    finest = trice.finest_partition_order(T, 64)
    assert finest == jrice.finest_partition_order(T, 64)
    got = rice_tables.rice_cost_tables(
        torch.from_numpy(errors), torch.from_numpy(warmup), finest
    ).numpy()
    pallas = np.asarray(pallas_rice.rice_cost_tables_pallas(
        jnp.asarray(errors), jnp.asarray(warmup), T, finest
    ))
    assert got.dtype == np.int32 and got.shape == (4, 4, 1 << finest, 32)
    assert np.array_equal(got, pallas)
    tables = trice._finest_tables(
        torch.from_numpy(errors), torch.from_numpy(warmup), finest
    ).numpy()
    assert np.array_equal(tables, _jax_tables(errors, warmup, T))


def test_every_warmup_0_to_24():
    T = 1024
    errors, _ = _errors(1, 25, 1, T)
    warmup = np.arange(25, dtype=np.int32)[:, None]
    finest = trice.finest_partition_order(T, 64)
    got = rice_tables.rice_cost_tables_plain(
        torch.from_numpy(errors), torch.from_numpy(warmup), finest
    ).numpy()
    pallas = np.asarray(pallas_rice.rice_cost_tables_pallas(
        jnp.asarray(errors), jnp.asarray(warmup), T, finest
    ))
    assert np.array_equal(got, pallas)


def test_saturation_clamps_once():
    # 8 samples of |e| = 2^27 in partition 0 saturate every rule the same way
    T = 4096
    finest = trice.finest_partition_order(T, 64)
    errors = np.zeros((1, 1, T), np.int32)
    errors[0, 0, :8] = -(1 << 27)
    got = rice_tables.rice_cost_tables(
        torch.from_numpy(errors), torch.zeros((1, 1), dtype=torch.int32), finest
    ).numpy()
    assert got[0, 0, 0, 0] == rice_tables.MAX_P_TO_BITS
    assert np.all(got[0, 0, 1:] == 0)
    pallas = np.asarray(pallas_rice.rice_cost_tables_pallas(
        jnp.asarray(errors), jnp.zeros((1, 1), jnp.int32), T, finest
    ))
    assert np.array_equal(got, pallas)


def test_near_int32_limit_follows_i64_rule():
    """zz = 2^31+2 and 2^31+3 in one 16-sample chunk: the Pallas u32 chain
    wraps their sum to 5, the i64 rule clamps it to MAX_P_TO_BITS. The port
    follows the JAX default (XLA, i64) path."""
    T = 1024
    finest = trice.finest_partition_order(T, 64)
    errors = np.zeros((1, 1, T), np.int32)
    errors[0, 0, 0] = (1 << 30) + 1       # zz = 2^31 + 2
    errors[0, 0, 1] = -((1 << 30) + 2)    # zz = 2^31 + 3
    errors[0, 0, 70] = np.iinfo(np.int32).min  # zz = 2^32 - 1
    warmup = np.zeros((1, 1), np.int32)
    got = rice_tables.rice_cost_tables(
        torch.from_numpy(errors), torch.from_numpy(warmup), finest
    ).numpy()
    pallas = np.asarray(pallas_rice.rice_cost_tables_pallas(
        jnp.asarray(errors), jnp.asarray(warmup), T, finest
    ))
    assert pallas[0, 0, 0, 0] == 5  # u32 wrap
    assert got[0, 0, 0, 0] == rice_tables.MAX_P_TO_BITS
    # p where the i64 sums stay below the clamp: exact shifted sums
    z = np.array([(1 << 31) + 2, (1 << 31) + 3], np.int64)
    for p in range(32):
        assert got[0, 0, 0, p] == min(int((z >> p).sum()), rice_tables.MAX_P_TO_BITS)
    assert got[0, 0, 1, 31] == 1  # (2^32 - 1) >> 31
    tables = trice._finest_tables(
        torch.from_numpy(errors), torch.from_numpy(warmup), finest
    ).numpy()
    assert np.array_equal(tables, _jax_tables(errors, warmup, T))


def test_zigzag_matches_jax():
    v = np.array([0, 1, -1, 2, -2, 32767, -32768, (1 << 30), -(1 << 30),
                  np.iinfo(np.int32).max, np.iinfo(np.int32).min], np.int32)
    got = trice.encode_signbit(torch.from_numpy(v)).numpy()
    exp = np.asarray(jrice.encode_signbit(jnp.asarray(v))).astype(np.int64)
    assert np.array_equal(got, exp)


def _search_both(errors, warmup, T, max_p):
    got = trice.find_partitioned_rice_parameters(
        torch.from_numpy(errors), torch.from_numpy(warmup), T, max_p
    )
    exp = _jax_search(jnp.asarray(errors), jnp.asarray(warmup), T, max_p)
    for name in ("partition_order", "params", "code_bits", "use_rice2"):
        g = getattr(got, name).numpy()
        e = np.asarray(getattr(exp, name))
        assert g.shape == e.shape and np.array_equal(g, e.astype(g.dtype)), name
    assert np.array_equal(
        trice.residual_count_bits(got).numpy(),
        np.asarray(jrice.residual_count_bits(exp)),
    )
    return got


@pytest.mark.parametrize("max_p", [14, 30])
@pytest.mark.parametrize("T", [1024, 4096])
def test_search_matches_jax(T, max_p):
    errors, warmup = _errors(2, 2, 4, T)
    # loud rows push parameters past 14 (RICE2 / max_p masking)
    errors[1] = errors[1] * 4096
    got = _search_both(errors, warmup, T, max_p)
    if max_p == 30:
        assert bool(got.use_rice2.any())


def test_search_order_tie_prefers_finest():
    """Seed 2 gives rows 0 and 17 whose order-1 and order-0 costs tie: the
    first-minimum argmin must keep the finer order, like the reference."""
    rng = np.random.default_rng(2)
    errors = rng.integers(-40, 40, (32, 1, 128)).astype(np.int32)
    errors[:, :, 64:] *= rng.integers(1, 5, (32, 1, 1)).astype(np.int32)
    warmup = np.zeros((32, 1), np.int32)
    tables = trice._finest_tables(torch.from_numpy(errors), torch.from_numpy(warmup), 1)
    fine = trice._minimize_tables(tables, 30)[1].sum(dim=-1)
    merged = torch.clamp(tables[..., 0::2, :] + tables[..., 1::2, :] - 4,
                         max=trice.MAX_P_TO_BITS)
    coarse = trice._minimize_tables(merged, 30)[1].sum(dim=-1)
    ties = torch.nonzero((fine == coarse)[:, 0])[:, 0].tolist()
    assert ties == [0, 17]
    got = _search_both(errors, warmup, 128, 30)
    assert got.partition_order[ties, 0].tolist() == [1, 1]


def test_minimize_tables_masked_entries_wrap():
    # p > max_p packs as 0xFFFFFFE0 | p: never chosen over a real entry
    tables = torch.full((1, 32), trice.MAX_P_TO_BITS, dtype=torch.int64)
    tables[0, 20] = 5  # cheapest, but masked at max_p = 14
    p, bits = trice._minimize_tables(tables, 14)
    assert int(p) == 0 and int(bits) == trice.MAX_P_TO_BITS


@pytest.mark.parametrize("bad", ["dtype", "shape", "warmup", "order", "block_size"])
def test_wrapper_rejects_bad_input(bad):
    e = torch.zeros((2, 3, 256), dtype=torch.int32)
    w = torch.zeros((2, 3), dtype=torch.int32)
    finest = 2
    if bad == "dtype":
        e = e.to(torch.int64)
    elif bad == "shape":
        e = e[0]
    elif bad == "warmup":
        w = w[:, :2]
    elif bad == "block_size":
        e = torch.zeros((2, 3, 32768), dtype=torch.int32)  # above FLAC's 32767
    else:
        finest = 9  # 256 does not split into 512 partitions
    with pytest.raises(ValueError):
        rice_tables.rice_cost_tables(e, w, finest)


def test_cpu_tensor_takes_plain_path_without_counting():
    before = rice_tables.launches()
    rice_tables.rice_cost_tables(
        torch.zeros((1, 1, 128), dtype=torch.int32),
        torch.zeros((1, 1), dtype=torch.int32), 1,
    )
    assert rice_tables.launches() == before
    assert all(dev.type == "cuda" for dev in rice_tables._RUNS)  # no counter for the CPU


# ---- the CUDA kernel's arithmetic and indexing, held on the CPU ----


def _shfl_down(v, d):
    """__shfl_down_sync over the last axis (32 lanes): lane + d's value, the
    lane's own where lane + d >= 32."""
    return torch.cat([v[..., d:], v[..., 32 - d:]], dim=-1)


def _clamped_suffix_sums(counts):
    """csrc/rice_tables.cu `clamped_suffix_sums` step for step: (..., 32)
    bit counts -> (..., 32) int32 min(sum_{k >= p} c_k 2^(k - p), MAX), every
    intermediate checked to fit the kernel's 32-bit registers."""
    assert int(counts.max()) <= 32767
    lane = torch.arange(32)
    v = counts.to(torch.int64)
    for d in (1, 2, 4, 8):
        v = torch.where(lane + d < 32, v + (_shfl_down(v, d) << d), v)
        assert int(v.max()) < 1 << 31
    u = torch.clamp(_shfl_down(v, 16), max=(rice_tables.MAX_P_TO_BITS >> 16) + 1)
    v = torch.where(lane < 16, v + (u << 16), v)
    assert int(v.max()) < 1 << 32
    return torch.clamp(v, max=rice_tables.MAX_P_TO_BITS).to(torch.int32)


def _bit_counts(z):
    """(..., n) u32 values held in int64 -> (..., 32) counts of set bits."""
    return torch.stack([((z >> k) & 1).sum(dim=-1) for k in range(32)], dim=-1)


def _bit_plane_tables(errors, warmup, finest):
    """The tables the bit-plane way: per partition the counts c_k of zigzag
    values with bit k set, then S_p = c_p + 2 S_{p+1} as the kernel scans."""
    B, K, T = errors.shape
    z = rice_tables.encode_signbit(errors)
    z = torch.where(torch.arange(T) < warmup[..., None].to(torch.int64), 0, z)
    counts = _bit_counts(z.reshape(B, K, 1 << finest, T >> finest))
    return _clamped_suffix_sums(counts)


@functools.lru_cache(maxsize=1)
def _kernel_cases():
    return chip_smoke.kernel_cases()


@pytest.mark.parametrize("case", range(8))
def test_bit_plane_tables_equal_plain_on_every_smoke_case(case):
    """Every case chip_smoke.py holds the kernel to on the card."""
    assert len(_kernel_cases()) == 8
    name, errors, warmup = _kernel_cases()[case]
    finest = trice.finest_partition_order(errors.shape[-1], 64)
    e, w = torch.from_numpy(errors), torch.from_numpy(warmup)
    got = _bit_plane_tables(e, w, finest)
    exp = rice_tables.rice_cost_tables_plain(e, w, finest)
    assert got.shape == exp.shape and torch.equal(got, exp), name


_M32 = 0xFFFFFFFF


def _warp_transpose(x):
    """csrc/rice_tables.cu `Transpose` on 32 lanes' u32 words (uint64
    array): __byte_perm rounds 16 and 8, rotate-and-select rounds 4, 2, 1."""
    lanes = np.arange(32)

    def byte_perm(a, b, sel):
        src = np.stack([(a >> (8 * i)) & 0xFF for i in range(4)]
                       + [(b >> (8 * i)) & 0xFF for i in range(4)])
        return sum(src[(sel >> (4 * i)) & 7, lanes] << np.uint64(8 * i) for i in range(4))

    x = byte_perm(x, x[lanes ^ 16], np.where(lanes & 16, 0x3276, 0x5410))
    x = byte_perm(x, x[lanes ^ 8], np.where(lanes & 8, 0x3715, 0x6240))
    for s, low in ((4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555)):
        high = (lanes & s) != 0
        keep = np.where(high, ~low & _M32, low).astype(np.uint64)
        rot = np.where(high, 32 - s, s).astype(np.uint64)
        y = x[lanes ^ s]
        t = ((y << rot) | (y >> (np.uint64(32) - rot))) & np.uint64(_M32)
        x = (x & keep) | (t & ~keep & np.uint64(_M32))
    return x


def test_warp_transpose():
    x = np.random.default_rng(5).integers(0, 1 << 32, 32, dtype=np.uint64)
    got = _warp_transpose(x)
    bits = (x[:, None] >> np.arange(32, dtype=np.uint64)) & np.uint64(1)  # [lane j, bit k]
    exp = (bits.T << np.arange(32, dtype=np.uint64)).sum(axis=1)  # lane k: bit j = bits[j, k]
    assert np.array_equal(got, exp)


def _simulated_kernel(errors, warmup, finest, parts_per_block, warps=4, unroll=4):
    """csrc/rice_tables.cu `rice_cost_tables_transpose` in Python, lane by
    lane: the grid, the warps' step runs, the unrolled loads, the warmup
    mask, the warp bit transpose and __popc, the split and direct flushes and
    the clamped scan. Returns the (B, K, nparts, 32) tables."""
    B, K, T = errors.shape
    rows = errors.reshape(B * K, T).astype(np.int64)
    zz = ((rows << 1) ^ (rows >> 31)) & _M32
    warm = warmup.reshape(-1)
    nparts, part_len = 1 << finest, T >> finest
    groups = nparts // parts_per_block
    steps_per_part = -(-part_len // 32)
    steps = parts_per_block * steps_per_part
    per_warp = -(-steps // warps)
    split = per_warp % steps_per_part != 0 and steps > per_warp
    lanes = np.arange(32)
    out = np.full((B * K, nparts, 32), -1, np.int64)
    seen = np.zeros((B * K, T), np.int64)

    def scan(count):
        return _clamped_suffix_sums(torch.from_numpy(count)).numpy()

    for block in range(B * K * groups):
        row, first = block // groups, (block % groups) * parts_per_block
        shared = np.zeros((parts_per_block, 32), np.int64)
        for warp in range(warps):
            begin = min(warp * per_warp, steps)
            end = min(begin + per_warp, steps)
            part, within = divmod(begin, steps_per_part)
            count = np.zeros(32, np.int64)
            for s in range(begin, end, unroll):
                q, w, loaded = part, within, []
                for u in range(unroll):
                    part_start = (first + q) * part_len
                    t = part_start + w * 32 + lanes
                    valid = (s + u < end) & (t < part_start + part_len)
                    loaded.append((t, valid, np.where(valid, zz[row][np.where(valid, t, 0)], 0)))
                    w += 1
                    if w == steps_per_part:
                        w, q = 0, q + 1
                for u, (t, valid, vals) in enumerate(loaded):
                    if s + u >= end:
                        continue
                    z = np.where(t < warm[row], 0, vals).astype(np.uint64)
                    count += np.bitwise_count(_warp_transpose(z)).astype(np.int64)
                    np.add.at(seen[row], t[valid], 1)
                    within += 1
                    if within == steps_per_part:
                        if split:
                            shared[part] += count
                        else:
                            out[row, first + part] = scan(count)
                        count[:], within, part = 0, 0, part + 1
            if split and within != 0:
                shared[part] += count
        if split:
            for q in range(parts_per_block):
                out[row, first + q] = scan(shared[q])
    assert np.all(seen == 1)  # every sample counted once
    assert np.all(out >= 0)  # every table entry written
    return torch.from_numpy(out.reshape(B, K, nparts, 32)).to(torch.int32)


def _simulated_mma_kernel(errors, warmup, finest, warps_per_block=4):
    """csrc/rice_tables.cu `rice_cost_tables_mma` in Python, lane by lane:
    8 partitions per warp over the flat (rows * nparts) list, each lane a
    quarter of its partition's samples, the m8n8k128 AND-popc product with
    the one-bit B masks, and the registers-and-4-lane-scan finish."""
    B, K, T = errors.shape
    nparts, part_len = 1 << finest, T >> finest
    total = B * K * nparts
    flat = errors.reshape(-1).astype(np.int64)
    zz_all = ((flat << 1) ^ (flat >> 31)) & _M32
    warm_rows = warmup.reshape(-1)
    out = np.full((total, 32), -1, np.int64)
    lanes = np.arange(32)
    r, quarter = lanes // 4, lanes % 4
    mask = np.stack([(1 << (8 * (r // 2) + 2 * j + r % 2)) for j in range(4)])  # [j, lane]
    per_lane = part_len // 4
    cap = rice_tables.MAX_P_TO_BITS
    n_warps = -(-total // 8)
    for warp in range(-(-n_warps // warps_per_block) * warps_per_block):
        first = warp * 8
        if first >= total:
            continue
        part = first + r
        valid = part < total
        t0 = quarter * per_lane
        warm = np.where(valid & (part % nparts == 0), warm_rows[np.minimum(part, total - 1) // nparts], 0)
        count = np.zeros((4, 2, 32), np.int64)  # [j, b, lane]
        for c in range(per_lane):
            idx = np.where(valid, part * part_len + t0 + c, 0)
            z = np.where(valid, zz_all[idx], 0)
            z = np.where(t0 + c < warm, 0, z)
            for j in range(4):
                # d[g][col] += sum_i popc(A[g, i] & B[col, i]); lane (g, i) holds A[g, i]
                # = its z and B[g, i] = mask[j, lane]; it receives d[g][2i], d[g][2i + 1]
                a_words = z.reshape(8, 4)
                b_words = mask[j].reshape(8, 4)
                d = np.bitwise_count(a_words[:, None, :] & b_words[None, :, :]).sum(-1).astype(np.int64)
                count[j, 0] += d[r, 2 * quarter]
                count[j, 1] += d[r, 2 * quarter + 1]
        local = np.zeros((8, 32), np.int64)
        acc = np.zeros(32, np.int64)
        for b in range(7, -1, -1):
            acc = count[b // 2, b % 2] + 2 * acc
            local[b] = acc
        assert local.max() < 1 << 18

        def shfl_down4(x, d):
            src = np.where(quarter + d < 4, lanes + d, lanes)
            return x[src]

        v = local[0].copy()
        v = np.where(quarter < 3, v + (shfl_down4(v, 1) << 8), v)
        v = np.where(quarter < 2, v + (np.minimum(shfl_down4(v, 2), (cap >> 16) + 1) << 16), v)
        assert v.max() < 1 << 32
        above = np.where(quarter < 3, shfl_down4(v, 1), 0)
        for b in range(8):
            carry = np.minimum(above, (cap >> (8 - b)) + 1) << (8 - b)
            entry = np.minimum(local[b] + carry, cap)
            assert (local[b] + carry).max() < 1 << 32
            out[part[valid], 8 * quarter[valid] + b] = entry[valid]
    assert np.all(out >= 0)  # every table entry written
    return torch.from_numpy(out.reshape(B, K, nparts, 32)).to(torch.int32)


@pytest.mark.parametrize("T,finest,offset", [
    (4096, 6, 0),   # the main path: 64-sample partitions, tensor cores
    (4096, 5, 0),   # 128-sample partitions, tensor cores
    (4096, 6, 1),   # rows not aligned to 16 bytes: transposes
    (1024, 4, 0),
    (4096, 2, 0),   # 1024-sample partitions: the tensor cores' longest
    (4096, 1, 0),   # 2048-sample partitions: transposes, one partition per block
    (4095, 0, 0),   # one partition split over the block's warps
    (4608, 6, 0),   # 72-sample partitions: a masked last step
    (1152, 4, 0),
    (1024, 2, 0),   # 256-sample partitions
    (32, 0, 0),     # one 32-sample partition: tensor cores
    (48, 0, 1),     # 48 samples, unaligned: a masked 32-sample step
])
def test_kernel_indexing_covers_every_sample_once(T, finest, offset):
    _check_simulated(T, finest, rice_tables.launch_plan(T, finest, 256 + 4 * offset))


def _check_simulated(T, finest, plan):
    rng = np.random.default_rng(T + finest)
    errors = rng.integers(-(1 << 20), 1 << 20, (2, 2, T)).astype(np.int32)
    errors[0, 0, :3] = [np.iinfo(np.int32).min, (1 << 30) + 1, -(1 << 27)]
    warmup = np.array([[0, 5], [24, 1]], np.int32)
    if plan.kernel == "mma":
        got = _simulated_mma_kernel(errors, warmup, finest)
    else:
        got = _simulated_kernel(errors, warmup, finest, plan.parts_per_block)
    e, w = torch.from_numpy(errors), torch.from_numpy(warmup)
    assert torch.equal(got, rice_tables.rice_cost_tables_plain(e, w, finest))


@pytest.mark.parametrize("T,finest,parts", [
    (1024, 4, 2),  # two-step partitions cut between warps: shared-memory flushes
    (1024, 4, 16),
    (4096, 6, 16),
])
def test_kernel_indexing_with_other_legal_plans(T, finest, parts):
    _check_simulated(T, finest, rice_tables.Plan("transpose", parts))


@pytest.mark.parametrize("T,finest,ptr,plan", [
    (4096, 6, 256, ("mma", 0)),
    (4096, 5, 256, ("mma", 0)),
    (4096, 6, 264, ("transpose", 8)),
    (16384, 8, 512, ("mma", 0)),
    (4096, 2, 256, ("mma", 0)),
    (4096, 1, 256, ("transpose", 1)),
    (1024, 2, 264, ("transpose", 2)),
    (4095, 0, 256, ("transpose", 1)),
    (32767, 0, 256, ("transpose", 1)),
    (4608, 6, 256, ("transpose", 4)),
    (32, 0, 256, ("mma", 0)),
])
def test_launch_plan(T, finest, ptr, plan):
    assert rice_tables.launch_plan(T, finest, ptr) == plan
