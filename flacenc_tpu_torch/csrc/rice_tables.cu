// Finest-partition Rice cost tables for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flacenc_tpu/ops/pallas_rice.py`
// (`rice_cost_tables_pallas`, body `_kernel`). For each row (one block x
// candidate channel) of `errors` (rows, T) int32 it computes
//
//   out[row, part, p] = min(sum_{t in part, t >= warmup[row]} (zz(e[t]) >> p),
//                           (1 << 27) - 1)            for p = 0..31,
//
// with zz the zigzag map (|e| << 1) - (e < 0) as u32. Length terms are added
// by the caller (flacenc_tpu_torch/ops/rice.py). Saturation rule: the sums
// are exact (at most 32767 * (2^32 - 1)) and clamped once, the rule of the
// JAX package's default XLA path, so every decision equals that path's.
//
// Bound: the function moves bytes and does little arithmetic on them. At
// the main path's shape (256 rows of T = 4096, 64 partitions of 64 samples)
// it reads 4 MiB of residuals and writes 2 MiB of tables: 6.29 MB, 1.88 us at
// the H100's 3.35 TB/s. Summing z >> p for every p costs about 4 warp
// instructions per sample (a shuffle, a shift, a 64-bit add), which made the
// first version of this kernel issue-bound at 8.5 us. Both kernels here
// count bit planes instead:
//
//   sum_t (z_t >> p) = sum_{k >= p} c_k 2^(k - p),   c_k = #{t : bit k of z_t},
//
// and finish each partition with S_p = c_p + 2 S_{p+1} in 32-bit registers,
// capping an addend at 2^27 where a shift could overflow (a capped sum is
// above the clamp, so the clamped result stays exact).
//
// - rice_cost_tables_mma (partitions of 16..1024 samples, a multiple of 16:
//   every power-of-two block size from 64 up). The tensor cores count the
//   bits: an m8n8k128 AND-popc product of 8 partitions' samples (A) with
//   one-bit masks (B) adds, for 8 bit positions, how many of 4 samples per
//   partition have the bit set. A warp takes 8 partitions, a lane a quarter
//   of one, with its 16-byte loads issued before their arithmetic; 4
//   products per sample cover the 32 positions, and the lane ends with 8
//   consecutive counts, so the finish needs 3 shuffles per 8 partitions.
//   Shuffles, not the arithmetic, bound a warp-shuffle design on this card
//   (one warp shuffle per SM clock): a 32 x 32 bit transpose per 32 samples
//   plus a 5-step scan per partition ran at 5.0 us, this kernel at 2.6 us.
// - rice_cost_tables_transpose (any other partition length, such as odd
//   block sizes' single partition of up to 32767 samples). 32 samples held
//   one per lane go through a 32 x 32 bit transpose (5 shuffle rounds), after
//   which lane k holds bit k of every sample and __popc adds its share of
//   c_k; a 5-step suffix scan finishes each partition. A block of 4 warps
//   takes a group of partitions of one row; a partition its warps share is
//   summed in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNumP = 32;
constexpr unsigned kMaxPToBits = (1u << 27) - 1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned zigzag(int32_t e) {
  return (static_cast<unsigned>(e) << 1) ^ static_cast<unsigned>(e >> 31);
}

// ---- Tensor-core bit counts (partitions of 16..1024 samples, 16 | length) ----

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaRows = 8;  // partitions per warp: the rows of one m8n8k128 product
constexpr int kMmaMaxPart = 1024;

// d += popc(a & b) over 128-bit rows and columns: an 8 x 8 x 128 binary
// product. Lane (g = lane / 4, i = lane % 4) gives bits 32i..32i+31 of row
// g of A and of column g of B, and receives d[g][2i] and d[g][2i + 1].
__device__ __forceinline__ void and_popc_mma(int& d0, int& d1, unsigned a, unsigned b) {
  asm volatile(
      "mma.sync.aligned.m8n8k128.row.col.s32.b1.b1.s32.and.popc {%0,%1}, {%2}, {%3}, {%0,%1};"
      : "+r"(d0), "+r"(d1)
      : "r"(a), "r"(b));
}

// The tables of 8 partitions per warp, flat over all rows (partition P of
// the (rows * nparts) list starts at sample P * part_len). Lane (r, i) holds
// partition r of the warp and counts the quarter [i, i + 1) * part_len / 4
// of its samples: each sample z is row r's share of A in 4 products, one
// per group of 8 bit positions, whose B columns are one-bit masks. B column
// c of group j tests bit 8 (c / 2) + 2 j + c % 2, so lane (r, i) ends with
// the counts of bits 8 i .. 8 i + 7 of its partition. It finishes them with
// the recurrence S_p = c_p + 2 S_{p+1} in registers, takes S_{8 i + 8} from
// the lane above after a 2-step scan over the row's 4 lanes, and stores 8
// entries.
__global__ void __launch_bounds__(kMmaThreads)
rice_cost_tables_mma(const int32_t* __restrict__ errors,
                     const int32_t* __restrict__ warmup,
                     int32_t* __restrict__ out, int total_parts,
                     int finest_order, int part_len) {
  const int lane = threadIdx.x % 32;
  const int first = (blockIdx.x * kMmaWarps + threadIdx.x / 32) * kMmaRows;
  if (first >= total_parts) return;  // the whole warp
  const int r = lane / 4;
  const int quarter = lane % 4;
  const int part = first + r;
  const bool valid = part < total_parts;
  const int per_lane = part_len / 4;  // a multiple of 4
  const int t0 = quarter * per_lane;  // first sample of the lane in its partition
  const int4* src =
      reinterpret_cast<const int4*>(errors + static_cast<size_t>(part) * part_len + t0);
  // the row's warmup zeroes samples of its first partition only
  const int warm =
      valid && (part & ((1 << finest_order) - 1)) == 0 ? warmup[part >> finest_order] : 0;

  unsigned mask[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) mask[j] = 1u << (8 * (r / 2) + 2 * j + r % 2);
  int count[4][2] = {};

  for (int c = 0; c < per_lane; c += 16) {
    int4 q[4];  // the loads of 16 samples before their arithmetic
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      q[u] = valid && c + 4 * u < per_lane ? __ldg(src + c / 4 + u) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const unsigned z = t0 + c + 4 * u + v < warm ? 0u : zigzag(e[v]);
#pragma unroll
        for (int j = 0; j < 4; ++j) and_popc_mma(count[j][0], count[j][1], z, mask[j]);
      }
    }
  }

  // local[b] = sum_{b' = b..7} c_{8 quarter + b'} 2^(b' - b), below 2^18
  unsigned local[8];
  unsigned acc = 0;
#pragma unroll
  for (int b = 7; b >= 0; --b) {
    acc = static_cast<unsigned>(count[b / 2][b % 2]) + 2 * acc;
    local[b] = acc;
  }
  // S_{8 quarter} over the row's 4 lanes: v_i = local_i[0] + 2^8 v_{i+1}
  unsigned v = local[0];
  unsigned u = __shfl_down_sync(kFull, v, 1, 4);
  if (quarter < 3) v += u << 8;  // below 2^26 + 2^18
  u = __shfl_down_sync(kFull, v, 2, 4);
  if (quarter < 2) v += min(u, (kMaxPToBits >> 16) + 1) << 16;
  u = __shfl_down_sync(kFull, v, 1, 4);
  const unsigned above = quarter < 3 ? u : 0;  // S_{8 quarter + 8}, or >= 2^27
  unsigned entry[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const unsigned carry = min(above, (kMaxPToBits >> (8 - b)) + 1) << (8 - b);
    entry[b] = min(local[b] + carry, kMaxPToBits);
  }
  if (valid) {
    int4* dst = reinterpret_cast<int4*>(out + static_cast<size_t>(part) * kNumP + 8 * quarter);
    dst[0] = make_int4(entry[0], entry[1], entry[2], entry[3]);
    dst[1] = make_int4(entry[4], entry[5], entry[6], entry[7]);
  }
}

// ---- Warp bit transposes (any partition length) ----

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxPartsPerBlock = 16;
constexpr int kUnroll = 4;

// 32 x 32 bit transpose across the warp. Round i exchanges blocks of
// s = 16 >> i bits with lane ^ s: the lane keeps the half of its word
// whose bit index agrees with its lane bit s and takes the other half from
// its partner's word. Rounds 16 and 8 move whole bytes (one byte
// permutation); rounds 4, 2 and 1 rotate the partner's word and select bits.
struct Transpose {
  unsigned perm[2];  // __byte_perm selectors of rounds 16 and 8
  unsigned keep[3];  // bits kept in rounds 4, 2 and 1
  int rot[3];        // left rotation of the partner's word in those rounds

  __device__ explicit Transpose(int lane) {
    perm[0] = lane & 16 ? 0x3276u : 0x5410u;
    perm[1] = lane & 8 ? 0x3715u : 0x6240u;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int s = 4 >> i;
      // bits b with (b & s) == 0: 0x0f0f0f0f, 0x33333333, 0x55555555
      const unsigned low = kFull / ((1u << (2 * s)) - 1) * ((1u << s) - 1);
      const bool high = lane & s;
      keep[i] = high ? ~low : low;
      rot[i] = high ? 32 - s : s;
    }
  }

  // Bit j of lane k's result is bit k of lane j's `x`.
  __device__ unsigned operator()(unsigned x) const {
    x = __byte_perm(x, __shfl_xor_sync(kFull, x, 16), perm[0]);
    x = __byte_perm(x, __shfl_xor_sync(kFull, x, 8), perm[1]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const unsigned y = __shfl_xor_sync(kFull, x, 4 >> i);
      const unsigned t = __funnelshift_l(y, y, rot[i]);
      x = (x & keep[i]) | (t & ~keep[i]);
    }
    return x;
  }
};

// S_lane = min(sum_{k >= lane} count_k 2^(k - lane), kMaxPToBits) for the
// bit counts of one partition (count_k <= 32767, held by lane k).
__device__ __forceinline__ unsigned clamped_suffix_sums(unsigned v, int lane) {
#pragma unroll
  for (int d = 1; d < 16; d <<= 1) {
    const unsigned u = __shfl_down_sync(kFull, v, d);
    if (lane + d < 32) v += u << d;  // stays below 32767 * 2^16
  }
  const unsigned u = __shfl_down_sync(kFull, v, 16);
  if (lane < 16) v += min(u, (kMaxPToBits >> 16) + 1) << 16;
  return min(v, kMaxPToBits);
}

// A block takes `parts_per_block` partitions of one row. Their steps of 32
// samples (the last step of a partition masked) are split into one run per
// warp. When the runs cut partitions, a cut partition's counts meet in
// shared memory (`split`, the same for the whole block); otherwise each warp
// finishes its own partitions.
__global__ void __launch_bounds__(kThreads)
rice_cost_tables_transpose(const int32_t* __restrict__ errors,
                           const int32_t* __restrict__ warmup,
                           int32_t* __restrict__ out, int block_size,
                           int finest_order, int parts_per_block) {
  __shared__ unsigned counts[kMaxPartsPerBlock][kNumP];

  const int nparts = 1 << finest_order;
  const int part_len = block_size >> finest_order;
  const int groups = nparts / parts_per_block;
  const int row = blockIdx.x / groups;
  const int first_part = (blockIdx.x % groups) * parts_per_block;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int32_t* src = errors + static_cast<size_t>(row) * block_size;
  int32_t* table = out + (static_cast<size_t>(row) * nparts + first_part) * kNumP;
  const int warm = warmup[row];

  const int steps_per_part = (part_len + 31) / 32;
  const int steps = parts_per_block * steps_per_part;
  const int per_warp = (steps + kWarps - 1) / kWarps;
  const int begin = min(warp * per_warp, steps);
  const int end = min(begin + per_warp, steps);
  const bool split = per_warp % steps_per_part != 0 && steps > per_warp;
  if (split) {
    for (int i = threadIdx.x; i < parts_per_block * kNumP; i += kThreads) {
      counts[i / kNumP][i % kNumP] = 0;
    }
    __syncthreads();
  }

  const Transpose transpose(lane);
  int part = begin / steps_per_part;           // partition of step `s`
  int within = begin - part * steps_per_part;  // its step inside it
  unsigned count = 0;  // lane k: samples of `part` seen so far with bit k set
  for (int s = begin; s < end; s += kUnroll) {
    // issue the loads of kUnroll steps before any of their arithmetic
    int32_t e[kUnroll];
    int t[kUnroll];
    int q = part, w = within;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int part_start = (first_part + q) * part_len;
      t[u] = part_start + w * 32 + lane;
      e[u] = s + u < end && t[u] < part_start + part_len ? __ldg(src + t[u]) : 0;
      if (++w == steps_per_part) w = 0, ++q;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s + u < end) {  // warp-uniform
        const unsigned z = t[u] < warm ? 0u : zigzag(e[u]);
        count += __popc(transpose(z));
        if (++within == steps_per_part) {
          if (split) {
            atomicAdd(&counts[part][lane], count);
          } else {
            table[part * kNumP + lane] = static_cast<int32_t>(clamped_suffix_sums(count, lane));
          }
          count = 0, within = 0, ++part;
        }
      }
    }
  }
  if (split) {
    if (within != 0) atomicAdd(&counts[part][lane], count);
    __syncthreads();
    for (int q = warp; q < parts_per_block; q += kWarps) {
      table[q * kNumP + lane] = static_cast<int32_t>(clamped_suffix_sums(counts[q][lane], lane));
    }
  }
}

}  // namespace

extern "C" {

// errors (rows, block_size) int32, warmup (rows,) int32 and
// out (rows, 1 << finest_order, 32) int32 are contiguous device buffers;
// block_size <= 32767. Each entry launches on `stream` and returns a
// cudaError_t (0 on success).

// Tensor-core bit counts: partition lengths (block_size >> finest_order)
// that are multiples of 16 up to 1024, `errors` aligned to 16 bytes.
int flacenc_rice_cost_tables_mma(const void* errors, const void* warmup,
                                 void* out, int rows, int block_size,
                                 int finest_order, void* stream) {
  const int part_len = block_size >> finest_order;
  if (part_len % 16 != 0 || part_len > kMmaMaxPart || block_size > 32767 ||
      reinterpret_cast<uintptr_t>(errors) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int total_parts = rows << finest_order;
  if (total_parts > 0) {
    const int warps = (total_parts + kMmaRows - 1) / kMmaRows;
    const int blocks = (warps + kMmaWarps - 1) / kMmaWarps;
    rice_cost_tables_mma<<<blocks, kMmaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(errors), static_cast<const int32_t*>(warmup),
        static_cast<int32_t*>(out), total_parts, finest_order, part_len);
  }
  return static_cast<int>(cudaGetLastError());
}

// Warp bit transposes, any partition length: `parts_per_block` (a power of
// two at most 16 that divides 1 << finest_order) partitions of a row per
// block.
int flacenc_rice_cost_tables_transpose(const void* errors, const void* warmup,
                                       void* out, int rows, int block_size,
                                       int finest_order, int parts_per_block,
                                       void* stream) {
  const int nparts = 1 << finest_order;
  if (parts_per_block < 1 || parts_per_block > kMaxPartsPerBlock ||
      nparts % parts_per_block != 0 || block_size > 32767) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows > 0) {
    rice_cost_tables_transpose<<<rows * (nparts / parts_per_block), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(errors), static_cast<const int32_t*>(warmup),
        static_cast<int32_t*>(out), block_size, finest_order, parts_per_block);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* flacenc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
