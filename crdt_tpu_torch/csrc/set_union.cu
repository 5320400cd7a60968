// Single-key columnar set union, bucket-local union and merge — the Hopper
// (sm_90a) port of three TPU kernels of crdt_tpu/ops/pallas_union.py:
//
//   mode UNION, one segment per lane   <- `_union_kernel` (:218), launched
//       by `sorted_union_columnar_fused` (pallas_call at :334);
//   mode UNION, B segments of Wb rows  <- `_make_bucketed_union_kernel`
//       (:1003, body `_bucketed_union_body` :932), launched by
//       `bucketed_union_columnar` (pallas_call at :1070);
//   mode MERGE                         <- `_merge_kernel` (:87), launched by
//       `bitonic_merge_columnar` (pallas_call at :120).
//
// What it computes, per lane j (planes are (C, L) int32, row-major, lane j =
// column j; keys ascending per lane with a SENTINEL tail, values 0 there):
//   UNION: each lane is cut into C/seg segments of `seg` rows (seg = C for
//     the full union, seg = Wb for the bucketed layout).  Segment s of the
//     output is the union of A's and B's segment s: keys ascending, a key
//     held by both sides appears once with its values OR-combined, a
//     SENTINEL key is padding; the first `out_seg` rows are written and
//     rows past the segment's unique count are SENTINEL / 0.  n_unique[j]
//     is the sum over segments of the unique counts before truncation,
//     seg_max[j] (bucketed layout only) their maximum.
//   MERGE: the 2C rows of A and B in ascending key order, nothing dropped;
//     of two equal keys A's copy comes first.
// On inputs that keep the host contract (unique keys per side, SENTINEL/0
// padding) the UNION output is bit-identical to the TPU kernels' on every
// plane: their bitonic network leaves the order of equal keys open, but the
// OR makes the kept copy a | b either way.  Values of any width are OR-ed
// exactly (the TPU kernels fold them into bits 16-30 of a displacement word
// and so take values < 2^15 only).  MERGE equals the TPU merge wherever the
// two copies of an equal key carry equal values.
//
// Two bodies:
//   * UNION with one segment (kernel 2, the OR-Set swarm join) runs the
//     lane-tile union of tile_union.cuh at one key word and one value plane:
//     persistent CTAs of 8-lane tiles, the next tile's key planes in flight
//     by cp.async while this one ranks by merge path and moves, the value
//     planes staged while it ranks, a map of output row -> source, whole
//     rows stored.  Its lane tile, stage counts and shared memory are the
//     host's (hopper_union.set_union_plan / set_union_smem_bytes); the host
//     passes a lane tile for this launch only, and the C entry takes the
//     tile body exactly when it is given one.
//   * the bucketed UNION (kernel 3) and MERGE (kernel 6) run the first
//     version's template below: a CTA takes a tile of LT adjacent lanes (LT
//     in {1, 2, 4, 8}, the largest whose shared memory fits kTileBudget, so
//     two CTAs share an SM), loads the four input planes cooperatively,
//     row-major, then a warp per (lane, segment) ranks each row of one side
//     against the other by a binary search in shared memory (merged position
//     = i + #(B < A[i]) for A, j + #(A <= B[j]) for B), drops B rows whose
//     key A also holds and shifts the rest down by the duplicates below them
//     (__ballot_sync/__popc), and writes the output tile back row-major.
//
// What bounds them on this card: bytes.  The union at C = 1024 reads 4
// planes and writes 2 planes + n_unique: 24 KB per lane, 25.8 GB at 2^20
// lanes, 7.69 ms at 3.35 TB/s.  The first version (now kernels 3 and 6
// only) loads, ranks and stores in turn, with a thread's few 4 B loads in
// flight only while it loads, its binary searches bank-conflicted and each
// sector half used at LT = 4; it ran kernel 2 at 5.5x that bound.  The tile
// body keeps loads in flight across the tiles, ranks with one shared load a
// merged row and moves whole sectors; what holds it now is the count of
// row requests at 2^20 lanes (tile_union.cuh).  The template's shared memory per
// CTA (LT lanes): 4 input planes of C rows plus 2 output planes of rows_out
// rows, each lane's column padded by 32/LT words so the tile's row-major
// stores to shared memory hit 32 distinct banks.  Past the card's opt-in
// limit (227 KB) cudaFuncSetAttribute refuses a launch and the wrapper
// raises.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_union.cuh"

namespace {

constexpr int32_t kSentinel = 0x7FFFFFFF;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLaneShift = 3;  // at most 8 lanes a CTA
// two CTAs per SM: Hopper's SM has 228 KB of shared memory, 1 KB of it
// reserved per CTA
constexpr size_t kTileBudget = 113 * 1024;

enum Mode { kUnion = 0, kMerge = 1 };

struct Params {
  const int32_t* ka;
  const int32_t* va;
  const int32_t* kb;
  const int32_t* vb;
  int32_t* ko;
  int32_t* vo;
  int32_t* n_unique;  // [lanes], UNION only
  int32_t* seg_max;   // [lanes] or null
  int c;              // rows per operand per lane
  int lanes;
  int seg;            // rows per segment per operand
  int out_seg;        // output rows per segment
  int lt_shift;       // log2 of the lanes per CTA
};

// #rows of arr[0, n) (ascending) below x (kStrict) or at or below x.
template <bool kStrict>
__device__ __forceinline__ int rank_in(const int32_t* arr, int n, int32_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool go_right = kStrict ? arr[mid] < x : arr[mid] <= x;
    if (go_right) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__host__ __device__ __forceinline__ int tile_pad(int lt) { return 32 / lt; }

// Union of one segment (n rows a side) into out[0, out_rows), by one warp.
// Returns the segment's unique count (on every lane of the warp).
__device__ int union_segment(const int32_t* a, const int32_t* av,
                             const int32_t* b, const int32_t* bv, int n,
                             int32_t* ok, int32_t* ov, int out_rows) {
  const int lid = threadIdx.x & 31;
  const unsigned below = (1u << lid) - 1u;
  int dups = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lid;
    const int32_t x = i < n ? a[i] : kSentinel;
    const bool real = x != kSentinel;
    const int cb = real ? rank_in<true>(b, n, x) : 0;
    const bool dup = real && cb < n && b[cb] == x;
    const unsigned m = __ballot_sync(0xffffffffu, dup);
    // rows of A below i are real (keys ascend, SENTINEL last), and the
    // duplicates below x are exactly A's duplicate rows below i
    const int pos = i + cb - (dups + __popc(m & below));
    if (real && pos < out_rows) {
      ok[pos] = x;
      ov[pos] = av[i] | (dup ? bv[cb] : 0);
    }
    dups += __popc(m);
  }
  int b_dups = 0;
  for (int base = 0; base < n; base += 32) {
    const int j = base + lid;
    const int32_t y = j < n ? b[j] : kSentinel;
    const bool real = y != kSentinel;
    const int ca = real ? rank_in<true>(a, n, y) : 0;
    const bool dup = real && ca < n && a[ca] == y;
    const unsigned m = __ballot_sync(0xffffffffu, dup);
    const int pos = j + ca - (b_dups + __popc(m & below));
    if (real && !dup && pos < out_rows) {
      ok[pos] = y;
      ov[pos] = bv[j];
    }
    b_dups += __popc(m);
  }
  const int unique = rank_in<true>(a, n, kSentinel) + rank_in<true>(b, n, kSentinel) - dups;
  for (int r = unique + lid; r < out_rows; r += 32) {
    ok[r] = kSentinel;
    ov[r] = 0;
  }
  return unique;
}

// Merge of A's and B's n rows into out[0, 2n), by one warp.
__device__ void merge_segment(const int32_t* a, const int32_t* av,
                              const int32_t* b, const int32_t* bv, int n,
                              int32_t* ok, int32_t* ov) {
  const int lid = threadIdx.x & 31;
  for (int i = lid; i < n; i += 32) {
    const int pos = i + rank_in<true>(b, n, a[i]);
    ok[pos] = a[i];
    ov[pos] = av[i];
  }
  for (int j = lid; j < n; j += 32) {
    const int pos = j + rank_in<false>(a, n, b[j]);
    ok[pos] = b[j];
    ov[pos] = bv[j];
  }
}

template <Mode kMode>
__global__ void __launch_bounds__(kThreads)
set_union_kernel(Params p) {
  extern __shared__ int32_t smem[];
  const int lt = 1 << p.lt_shift;
  const int n_seg = p.c / p.seg;
  const int rows_out = n_seg * p.out_seg;
  const int in_stride = p.c + tile_pad(lt);
  const int out_stride = rows_out + tile_pad(lt);
  const size_t lanes = (size_t)p.lanes;
  const size_t lane0 = (size_t)blockIdx.x << p.lt_shift;

  int32_t* s_ka = smem;                      // LT x in_stride each
  int32_t* s_va = s_ka + lt * in_stride;
  int32_t* s_kb = s_va + lt * in_stride;
  int32_t* s_vb = s_kb + lt * in_stride;
  int32_t* s_ko = s_vb + lt * in_stride;     // LT x out_stride each
  int32_t* s_vo = s_ko + lt * out_stride;
  int* s_nu = s_vo + lt * out_stride;        // LT
  int* s_max = s_nu + lt;                    // LT

  // 1. load the lane tile, row-major: thread -> (row, lane of the tile)
  for (int idx = threadIdx.x; idx < (p.c << p.lt_shift); idx += kThreads) {
    const int row = idx >> p.lt_shift, l = idx & (lt - 1);
    const size_t lane = lane0 + l;
    const int at = l * in_stride + row;
    if (lane < lanes) {
      const size_t g = (size_t)row * lanes + lane;
      s_ka[at] = p.ka[g];
      s_va[at] = p.va[g];
      s_kb[at] = p.kb[g];
      s_vb[at] = p.vb[g];
    } else {
      s_ka[at] = s_kb[at] = kSentinel;
      s_va[at] = s_vb[at] = 0;
    }
  }
  if (threadIdx.x < lt) s_nu[threadIdx.x] = s_max[threadIdx.x] = 0;
  __syncthreads();

  // 2. one warp per (lane, segment) work item
  const int warp = threadIdx.x >> 5;
  for (int item = warp; item < (n_seg << p.lt_shift); item += kWarps) {
    const int l = item / n_seg, s = item - l * n_seg;
    const int in_at = l * in_stride + s * p.seg;
    const int out_at = l * out_stride + s * p.out_seg;
    if (kMode == kMerge) {
      merge_segment(s_ka + in_at, s_va + in_at, s_kb + in_at, s_vb + in_at,
                    p.seg, s_ko + out_at, s_vo + out_at);
    } else {
      const int unique = union_segment(s_ka + in_at, s_va + in_at, s_kb + in_at,
                                       s_vb + in_at, p.seg, s_ko + out_at,
                                       s_vo + out_at, p.out_seg);
      if ((threadIdx.x & 31) == 0) {
        atomicAdd(&s_nu[l], unique);
        atomicMax(&s_max[l], unique);
      }
    }
  }
  __syncthreads();

  // 3. write the output tile back, row-major like the load
  for (int idx = threadIdx.x; idx < (rows_out << p.lt_shift); idx += kThreads) {
    const int row = idx >> p.lt_shift, l = idx & (lt - 1);
    const size_t lane = lane0 + l;
    if (lane < lanes) {
      const size_t g = (size_t)row * lanes + lane;
      p.ko[g] = s_ko[l * out_stride + row];
      p.vo[g] = s_vo[l * out_stride + row];
    }
  }
  if (kMode == kUnion && threadIdx.x < lt && lane0 + threadIdx.x < lanes) {
    p.n_unique[lane0 + threadIdx.x] = s_nu[threadIdx.x];
    if (p.seg_max != nullptr) p.seg_max[lane0 + threadIdx.x] = s_max[threadIdx.x];
  }
}

size_t smem_bytes(int c, int rows_out, int lt) {
  const size_t pad = tile_pad(lt);
  return sizeof(int32_t) * (size_t)lt * (4 * (c + pad) + 2 * (rows_out + pad) + 2);
}

int lane_tile_shift(int c, int rows_out) {
  int shift = kMaxLaneShift;
  while (shift > 0 && smem_bytes(c, rows_out, 1 << shift) > kTileBudget) --shift;
  return shift;
}

template <Mode kMode>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  auto kernel = set_union_kernel<kMode>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((p.lanes + (1 << p.lt_shift) - 1) >> p.lt_shift);
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Lanes per CTA and shared-memory bytes per CTA of the template (kernels 3
// and 6) for `c` rows per operand and `rows_out` output rows per lane.
int segment_union_lane_tile(int c, int rows_out) {
  return 1 << lane_tile_shift(c, rows_out);
}

size_t segment_union_smem_bytes(int c, int rows_out) {
  return smem_bytes(c, rows_out, segment_union_lane_tile(c, rows_out));
}

// Launch on `stream`.  mode 0 = union of segments of `seg` rows, each cut
// to `out_seg` rows (n_unique required, seg_max may be null); mode 1 =
// merge (seg = c, out_seg = 2c, n_unique and seg_max unused).  Planes are
// contiguous (c, lanes) int32, outputs (c / seg * out_seg, lanes).
// `lane_tile` > 0 runs the tile body with the host's `lane_tile`, `stages`,
// `stage_vals` and `smem` bytes a CTA; it takes the union of one segment
// (seg = c) without seg_max only.  `lane_tile` 0 runs the template, which
// ignores the other three.  Returns a cudaError_t.
int set_union(int mode, const void* ka, const void* va, const void* kb,
              const void* vb, void* ko, void* vo, void* n_unique, void* seg_max,
              int c, int lanes, int seg, int out_seg, int lane_tile, int stages,
              int stage_vals, int smem, void* stream) {
  if (lanes <= 0 || seg <= 0 || c % seg != 0 || out_seg < 0 ||
      out_seg > 2 * seg || (mode == kMerge && (seg != c || out_seg != 2 * c)) ||
      (mode == kUnion && n_unique == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lane_tile > 0) {
    if (mode != kUnion || seg != c || seg_max != nullptr) return cudaErrorInvalidValue;
    tile_union::Args t = {};
    t.a[0] = static_cast<const int32_t*>(ka);
    t.a[1] = static_cast<const int32_t*>(va);
    t.b[0] = static_cast<const int32_t*>(kb);
    t.b[1] = static_cast<const int32_t*>(vb);
    t.out[0] = static_cast<int32_t*>(ko);
    t.out[1] = static_cast<int32_t*>(vo);
    t.n_unique = static_cast<int32_t*>(n_unique);
    t.c = c;
    t.lanes = lanes;
    t.out_size = out_seg;
    t.n_keys = 1;
    t.n_vals = 1;
    t.lt = lane_tile;
    t.stages = stages;
    t.stage_vals = stage_vals;
    return tile_union::launch<1>(t, smem, s);
  }
  Params p = {};
  p.ka = static_cast<const int32_t*>(ka);
  p.va = static_cast<const int32_t*>(va);
  p.kb = static_cast<const int32_t*>(kb);
  p.vb = static_cast<const int32_t*>(vb);
  p.ko = static_cast<int32_t*>(ko);
  p.vo = static_cast<int32_t*>(vo);
  p.n_unique = static_cast<int32_t*>(n_unique);
  p.seg_max = static_cast<int32_t*>(seg_max);
  p.c = c;
  p.lanes = lanes;
  p.seg = seg;
  p.out_seg = out_seg;
  const int rows_out = c / seg * out_seg;
  p.lt_shift = lane_tile_shift(c, rows_out);
  const size_t bytes = smem_bytes(c, rows_out, 1 << p.lt_shift);
  if (mode == kUnion) return launch<kUnion>(p, bytes, s);
  if (mode == kMerge) return launch<kMerge>(p, bytes, s);
  return cudaErrorInvalidValue;
}

const char* set_union_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
