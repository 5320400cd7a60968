// The OR-Set union floors — the Hopper (sm_90a) port of the two TPU kernels
// of benches/orset_floor.py:
//
//   floor_union            <- `_floor_kernel` (:37), launched by
//       `floor_union` (pallas_call at :182): the pass structure of the
//       single-key union (crdt_tpu/ops/pallas_union.py `_union_kernel`),
//       every comparator replaced by a cheap combine;
//   bucketed_floor_union   <- `_make_bucketed_floor_kernel` (:86), launched
//       by `bucketed_floor_union` (pallas_call at :157): the same for the
//       bucket-local union (`_make_bucketed_union_kernel`).
//
// What it computes, per lane j (planes are (C, L) int32, row-major, lane j =
// column j).  The lane's 2C rows are cut into segments of 2·seg rows (seg =
// C for floor_union, Wb = C / n_buckets for the bucketed floor); segment s
// holds A's rows [s·seg, (s+1)·seg) followed by B's same rows REVERSED (the
// TPU host flipped B before the call; this kernel reads B's rows in reverse
// as it loads them).  In uint32 arithmetic (sums wrap, as XLA's int32 does):
//   1. butterflies at strides seg, seg/2, ..., 1: keys (a + b, a - b),
//      values (a | b, a ^ b).  The key stages commute, the value stages do
//      not: they run strictly from the widest stride down;
//   2. the punch, over the whole lane: keys += shift_down(keys, 1,
//      SENTINEL); vals |= shift_up(vals, 1, 0); keys ^= shift_up(keys, 1, 0);
//   3. p = inclusive prefix count of keys & 1 per segment; disp = p | vals
//      << 16; nu[j] = p at the lane's last row (the last segment's count);
//   4. a suffix sum of keys and a suffix OR of disp per segment;
//   5. out: the first out_seg rows of each segment, keys and disp >> 16
//      (arithmetic).
// The TPU kernel runs 3 and 4 as log2-step (Hillis-Steele) shift passes;
// a scan gives the same bits in one pass.
//
// Design (a simple, correct first version):
//   * a CTA takes a tile of LT adjacent lanes (LT in {1, 2, 4, 8}, the
//     largest whose shared memory fits kTileBudget, so three CTAs share an
//     SM: LT = 4 at C = 1024, 2 at C = 2048) and loads the four input planes
//     row-major as set_union.cu does — neighbouring threads read
//     neighbouring lanes, every load is coalesced, 16 B a thread where the
//     tile allows — into one column of 2C keys and one of 2C values a lane;
//   * then one warp a lane: the butterflies three stages at a time in
//     registers (8 rows a thread, one shared-memory round trip per three
//     stages); the punch, the prefix count and the suffix scans as three
//     passes in which each thread walks its own chunk of 2C/32 rows, with
//     one warp scan of the chunk totals between them (a pad word every
//     chunk keeps the 32 chunks on 32 banks);
//   * the kept rows go back row-major, coalesced like the load.
//
// What bounds it on this card: bytes.  At C = 1024 it reads 4 planes and
// writes 2·out + 1 rows a lane: 24 KB a lane at out = C, 3.22 GB at
// L = 131,072, 0.962 ms at 3.35 TB/s; the butterflies, punch and scans are
// 8.5 G int32 operations, 0.51 ms at 16.7 T op/s.  Shared memory a CTA:
// 2 · LT columns of 2C words and their pad words (rounded to 32, plus 32/LT
// so the tile's row-major stores hit distinct banks); 66.8 KB at C = 1024.  Past
// 48 KB the launcher opts in with cudaFuncSetAttribute; past the card's
// opt-in limit (227 KB, reached at LT = 1 when C = 16,384) that call fails
// and the wrapper raises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kSentinel = 0x7FFFFFFFu;
constexpr int kFlagShift = 16;
constexpr int kMaxLaneShift = 3;  // at most 8 lanes (warps) a CTA
// three CTAs an SM: Hopper's SM has 228 KB of shared memory, 1 KB of it
// reserved per CTA
constexpr size_t kTileBudget = 75 * 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const int32_t* ka;
  const int32_t* va;
  const int32_t* kb;
  const int32_t* vb;
  int32_t* ko;
  int32_t* vo;
  int32_t* nu;
  int c;          // rows per operand per lane
  int lanes;
  int seg_shift;  // log2 of the rows an operand puts in a segment
  int out_seg;    // output rows per segment
  int lt_shift;   // log2 of the lanes (warps) per CTA
};

__host__ __device__ __forceinline__ int ilog2(int x) {
  int s = 0;
  while ((1 << (s + 1)) <= x) ++s;
  return s;
}

// A lane's n = 2C rows are scanned by the 32 threads of its warp in chunks
// of R = n/32 rows (one row a thread below 32 rows).  Shared-memory word of
// row r: one pad word every max(R, 32) rows, so that the 32 chunk starts
// (and 32 consecutive rows) fall on 32 distinct banks.
__host__ __device__ __forceinline__ int pad_shift(int n) {
  const int r_shift = ilog2(n) - 5;
  return r_shift > 5 ? r_shift : 5;
}

__device__ __forceinline__ int pidx(int r, int ps) { return r + (r >> ps); }

// words of one lane's column of n rows, padded as above, rounded to 32 and
// offset by 32/LT so that LT columns start on different banks
__host__ __device__ __forceinline__ int col_stride(int n, int lt) {
  return ((n + (n >> pad_shift(n)) + 31) & ~31) + 32 / lt;
}

// K butterfly stages at strides m·2^(K-1), ..., m (m = 2^m_shift) over a
// lane's n rows, widest first: each group of 2^K rows that these stages
// mix goes through registers once.
template <int K>
__device__ __forceinline__ void butterflies(uint32_t* ks, uint32_t* vs, int n,
                                            int ps, int m_shift, int lid) {
  constexpr int kW = 1 << K;
  const int m = 1 << m_shift;
  for (int g = lid; g < (n >> K); g += 32) {
    const int base = (g & (m - 1)) | ((g >> m_shift) << (m_shift + K));
    uint32_t x[kW], v[kW];
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      const int r = pidx(base + (j << m_shift), ps);
      x[j] = ks[r];
      v[j] = vs[r];
    }
#pragma unroll
    for (int h = kW >> 1; h >= 1; h >>= 1) {
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        if (j & h) continue;
        const uint32_t a = x[j], b = x[j + h];
        x[j] = a + b;
        x[j + h] = a - b;
        const uint32_t va = v[j], vb = v[j + h];
        v[j] = va | vb;
        v[j + h] = va ^ vb;
      }
    }
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      const int r = pidx(base + (j << m_shift), ps);
      ks[r] = x[j];
      vs[r] = v[j];
    }
  }
}

// Exclusive scans over the warp's chunk totals within groups of `width`
// threads (a segment spanning several chunks): the sum of the chunks
// before this one, and the sum and OR of the chunks after it.
__device__ __forceinline__ uint32_t sum_before(uint32_t x, int width, int lid) {
  uint32_t incl = x;
  for (int d = 1; d < width; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, incl, d, width);
    if ((lid & (width - 1)) >= d) incl += y;
  }
  return incl - x;
}

__device__ __forceinline__ void after(uint32_t& sum, uint32_t& bits, int width, int lid) {
  uint32_t s = sum, b = bits;
  for (int d = 1; d < width; d <<= 1) {
    const uint32_t ys = __shfl_down_sync(kFull, s, d, width);
    const uint32_t yb = __shfl_down_sync(kFull, b, d, width);
    if ((lid & (width - 1)) + d < width) {
      s += ys;
      b |= yb;
    }
  }
  // exclusive: what the next thread of the group holds
  const uint32_t ns = __shfl_down_sync(kFull, s, 1, width);
  const uint32_t nb = __shfl_down_sync(kFull, b, 1, width);
  const bool last = (lid & (width - 1)) == width - 1;
  sum = last ? 0u : ns;
  bits = last ? 0u : nb;
}

// Steps 1-4 on one lane's columns (n = 2C rows, segments of seg2 rows), by
// one warp; leaves the suffix sums in ks and the suffix ORs of disp in vs
// on the output rows (the first out_seg of each segment) and writes nu.
__device__ void floor_lane(uint32_t* ks, uint32_t* vs, int n, int seg_shift,
                           int out_seg, int32_t* nu_slot) {
  const int lid = threadIdx.x & 31;
  const int ps = pad_shift(n);

  // 1. butterflies, strides seg .. 1, in groups of up to three stages
  int s = seg_shift;
  for (; s >= 2; s -= 3) {
    butterflies<3>(ks, vs, n, ps, s - 2, lid);
    __syncwarp();
  }
  if (s == 1) butterflies<2>(ks, vs, n, ps, 0, lid);
  if (s == 0) butterflies<1>(ks, vs, n, ps, 0, lid);
  __syncwarp();

  // each thread's chunk of rows [r0, r0 + R); a segment of seg2 rows spans
  // `width` chunks (1: the chunk holds whole segments, nothing carries)
  const int rows = n >= 32 ? n >> 5 : 1;
  const int r0 = lid * rows;
  const bool on = r0 < n;
  const int seg2 = 2 << seg_shift;
  const int width = seg2 > rows ? seg2 / rows : 1;

  // 2. the punch, one pass over the chunk:
  //      k1[i] = k[i] + k[i-1] (k[-1] = SENTINEL), k3[i] = k1[i] ^ k1[i+1],
  //      v2[i] = v[i] | v[i+1] (k1[n] = v[n] = 0);
  // the rows next to the chunk are read before any thread writes
  uint32_t k_prev = 0, k_next_chunk = 0, v_next_chunk = 0;
  if (on) {
    k_prev = r0 == 0 ? kSentinel : ks[pidx(r0 - 1, ps)];
    if (r0 + rows < n) {
      k_next_chunk = ks[pidx(r0 + rows, ps)];
      v_next_chunk = vs[pidx(r0 + rows, ps)];
    }
  }
  __syncwarp();
  uint32_t odd = 0;  // keys & 1 in the chunk
  if (on) {
    uint32_t k = ks[pidx(r0, ps)], v = vs[pidx(r0, ps)];
#pragma unroll 4
    for (int j = 0; j < rows; ++j) {
      const int i = r0 + j;
      const uint32_t kn = j + 1 < rows ? ks[pidx(i + 1, ps)] : k_next_chunk;
      const uint32_t vn = j + 1 < rows ? vs[pidx(i + 1, ps)] : v_next_chunk;
      const uint32_t k1n = i + 1 < n ? kn + k : 0u;
      const uint32_t k3 = (k + k_prev) ^ k1n;
      ks[pidx(i, ps)] = k3;
      vs[pidx(i, ps)] = v | vn;
      odd += k3 & 1u;
      k_prev = k;
      k = kn;
      v = vn;
    }
  }

  // 3. p = inclusive prefix count of keys & 1 per segment; disp = p | v2 << 16
  uint32_t p = sum_before(odd, width, lid);
  uint32_t k_sum = 0, d_or = 0;
  if (on) {
#pragma unroll 4
    for (int j = 0; j < rows; ++j) {
      const int i = r0 + j;
      if ((i & (seg2 - 1)) == 0) p = 0;
      const uint32_t k3 = ks[pidx(i, ps)];
      p += k3 & 1u;
      const uint32_t disp = p | (vs[pidx(i, ps)] << kFlagShift);
      vs[pidx(i, ps)] = disp;
      k_sum += k3;
      d_or |= disp;
    }
    if (r0 + rows == n && nu_slot != nullptr) *nu_slot = (int32_t)p;
  }

  // 4. suffix sum of keys and suffix OR of disp per segment, backwards over
  // the chunk from what the later chunks of its segment carry; only the
  // output rows are written back
  after(k_sum, d_or, width, lid);
  if (on) {
#pragma unroll 4
    for (int j = rows - 1; j >= 0; --j) {
      const int i = r0 + j;
      const int at = pidx(i, ps);
      if ((i & (seg2 - 1)) == seg2 - 1) k_sum = d_or = 0u;
      k_sum += ks[at];
      d_or |= vs[at];
      if ((i & (seg2 - 1)) < out_seg) {
        ks[at] = k_sum;
        vs[at] = d_or;
      }
    }
  }
}

// Load or store the tile's rows: four lanes (16 B) a thread and a row when
// kVec (LT >= 4, the lane count a multiple of 4, every plane on 16 B), else
// one.
template <bool kVec>
__device__ __forceinline__ void load_tile(const Params& p, uint32_t* s_k, uint32_t* s_v,
                                          int stride, int ps) {
  const int lt = 1 << p.lt_shift;
  const int seg = 1 << p.seg_shift;
  const size_t lanes = (size_t)p.lanes;
  const size_t lane0 = (size_t)blockIdx.x << p.lt_shift;
  constexpr int kW = kVec ? 4 : 1;
  const int per_row = lt / kW;
  // A's row i of segment s to merged row 2·seg·s + i, B's to
  // 2·seg·s + 2·seg - 1 - i (B reversed within its segment); lanes past
  // the last are filled with zeros
#pragma unroll 4
  for (int idx = threadIdx.x; idx < p.c * per_row; idx += blockDim.x) {
    const int row = idx / per_row, l0 = (idx - row * per_row) * kW;
    const size_t lane = lane0 + l0;
    const int sg = row >> p.seg_shift, i = row & (seg - 1);
    const int at_a = pidx(2 * seg * sg + i, ps);
    const int at_b = pidx(2 * seg * sg + 2 * seg - 1 - i, ps);
    uint32_t ka[kW] = {}, va[kW] = {}, kb[kW] = {}, vb[kW] = {};
    if (lane < lanes) {
      const size_t g = (size_t)row * lanes + lane;
      if constexpr (kVec) {
        const uint4 a = *reinterpret_cast<const uint4*>(p.ka + g);
        const uint4 b = *reinterpret_cast<const uint4*>(p.va + g);
        const uint4 c = *reinterpret_cast<const uint4*>(p.kb + g);
        const uint4 d = *reinterpret_cast<const uint4*>(p.vb + g);
        ka[0] = a.x; ka[1] = a.y; ka[2] = a.z; ka[3] = a.w;
        va[0] = b.x; va[1] = b.y; va[2] = b.z; va[3] = b.w;
        kb[0] = c.x; kb[1] = c.y; kb[2] = c.z; kb[3] = c.w;
        vb[0] = d.x; vb[1] = d.y; vb[2] = d.z; vb[3] = d.w;
      } else {
        ka[0] = (uint32_t)p.ka[g];
        va[0] = (uint32_t)p.va[g];
        kb[0] = (uint32_t)p.kb[g];
        vb[0] = (uint32_t)p.vb[g];
      }
    }
#pragma unroll
    for (int q = 0; q < kW; ++q) {
      const int col = (l0 + q) * stride;
      s_k[col + at_a] = ka[q];
      s_v[col + at_a] = va[q];
      s_k[col + at_b] = kb[q];
      s_v[col + at_b] = vb[q];
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store_tile(const Params& p, const uint32_t* s_k,
                                           const uint32_t* s_v, int stride, int ps) {
  const int lt = 1 << p.lt_shift;
  const int seg = 1 << p.seg_shift;
  const size_t lanes = (size_t)p.lanes;
  const size_t lane0 = (size_t)blockIdx.x << p.lt_shift;
  constexpr int kW = kVec ? 4 : 1;
  const int per_row = lt / kW;
  const int rows_out = (p.c >> p.seg_shift) * p.out_seg;
  for (int idx = threadIdx.x; idx < rows_out * per_row; idx += blockDim.x) {
    const int o = idx / per_row, l0 = (idx - o * per_row) * kW;
    const size_t lane = lane0 + l0;
    if (lane >= lanes) continue;
    const int sg = o / p.out_seg, i = o - sg * p.out_seg;
    const int at = pidx(2 * seg * sg + i, ps);
    const size_t g = (size_t)o * lanes + lane;
    int32_t k[kW], v[kW];
#pragma unroll
    for (int q = 0; q < kW; ++q) {
      k[q] = (int32_t)s_k[(l0 + q) * stride + at];
      v[q] = (int32_t)s_v[(l0 + q) * stride + at] >> kFlagShift;
    }
    if constexpr (kVec) {
      *reinterpret_cast<int4*>(p.ko + g) = make_int4(k[0], k[1], k[2], k[3]);
      *reinterpret_cast<int4*>(p.vo + g) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
      p.ko[g] = k[0];
      p.vo[g] = v[0];
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(32 << kMaxLaneShift)
set_floor_kernel(Params p) {
  extern __shared__ uint32_t smem[];
  const int lt = 1 << p.lt_shift;
  const int n = 2 * p.c;
  const int stride = col_stride(n, lt);
  const int ps = pad_shift(n);
  uint32_t* s_k = smem;                // LT columns of `stride` words
  uint32_t* s_v = smem + lt * stride;  // LT columns

  // 1. load the lane tile row-major, as set_union.cu does
  load_tile<kVec>(p, s_k, s_v, stride, ps);
  __syncthreads();

  // 2. one warp per lane of the tile
  const int warp = threadIdx.x >> 5;
  const size_t lane = ((size_t)blockIdx.x << p.lt_shift) + warp;
  floor_lane(s_k + warp * stride, s_v + warp * stride, n, p.seg_shift, p.out_seg,
             lane < (size_t)p.lanes ? p.nu + lane : nullptr);
  __syncthreads();

  // 3. write the kept rows back, row-major like the load
  store_tile<kVec>(p, s_k, s_v, stride, ps);
}

size_t smem_bytes(int c, int lt) {
  return sizeof(uint32_t) * 2 * (size_t)lt * (size_t)col_stride(2 * c, lt);
}

int lane_tile_shift(int c) {
  int shift = kMaxLaneShift;
  while (shift > 0 && smem_bytes(c, 1 << shift) > kTileBudget) --shift;
  return shift;
}

int log2_exact(int x) {
  int s = 0;
  while ((1 << s) < x) ++s;
  return (1 << s) == x ? s : -1;
}

int launch(const void* ka, const void* va, const void* kb, const void* vb,
           void* ko, void* vo, void* nu, int c, int lanes, int seg,
           int out_seg, void* stream) {
  const int seg_shift = log2_exact(seg);
  if (lanes <= 0 || log2_exact(c) < 0 || seg_shift < 0 || c % seg != 0 ||
      out_seg < 0 || out_seg > 2 * seg) {
    return cudaErrorInvalidValue;
  }
  Params p = {};
  p.ka = static_cast<const int32_t*>(ka);
  p.va = static_cast<const int32_t*>(va);
  p.kb = static_cast<const int32_t*>(kb);
  p.vb = static_cast<const int32_t*>(vb);
  p.ko = static_cast<int32_t*>(ko);
  p.vo = static_cast<int32_t*>(vo);
  p.nu = static_cast<int32_t*>(nu);
  p.c = c;
  p.lanes = lanes;
  p.seg_shift = seg_shift;
  p.out_seg = out_seg;
  p.lt_shift = lane_tile_shift(c);
  const int lt = 1 << p.lt_shift;
  const size_t smem = smem_bytes(c, lt);
  // four lanes a load when every tile row starts on 16 B
  const uintptr_t addr = (uintptr_t)ka | (uintptr_t)va | (uintptr_t)kb | (uintptr_t)vb |
                         (uintptr_t)ko | (uintptr_t)vo;
  const bool vec = lt >= 4 && lanes % 4 == 0 && addr % 16 == 0;
  auto kernel = vec ? set_floor_kernel<true> : set_floor_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((lanes + lt - 1) >> p.lt_shift);
  kernel<<<blocks, 32 * lt, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Lanes per CTA and shared-memory bytes per CTA at `c` rows per operand.
int set_floor_lane_tile(int c) { return 1 << lane_tile_shift(c); }

size_t set_floor_smem_bytes(int c) { return smem_bytes(c, set_floor_lane_tile(c)); }

// The floor of the single-key union: one segment of 2C rows a lane, the
// first `out_size` rows kept.  Planes are contiguous (c, lanes) int32 (B as
// the caller holds it, not flipped); outputs ko, vo (out_size, lanes) and
// nu (lanes).  Launches on `stream`; returns a cudaError_t.
int floor_union(const void* ka, const void* va, const void* kb, const void* vb,
                void* ko, void* vo, void* nu, int c, int lanes, int out_size,
                void* stream) {
  return launch(ka, va, kb, vb, ko, vo, nu, c, lanes, c, out_size, stream);
}

// The floor of the bucket-local union: n_buckets segments of 2·Wb rows a
// lane (Wb = c / n_buckets, a power of two), the first Wb rows of each
// kept; outputs ko, vo (c, lanes) and nu (lanes).
int bucketed_floor_union(const void* ka, const void* va, const void* kb,
                         const void* vb, void* ko, void* vo, void* nu, int c,
                         int lanes, int n_buckets, void* stream) {
  if (n_buckets < 1 || c % n_buckets != 0) return cudaErrorInvalidValue;
  const int wb = c / n_buckets;
  return launch(ka, va, kb, vb, ko, vo, nu, c, lanes, wb, wb, stream);
}

const char* set_floor_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
