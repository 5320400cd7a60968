// Single-key columnar set union, bucket-local union and merge — the Hopper
// (sm_90a) port of three TPU kernels of crdt_tpu/ops/pallas_union.py:
//
//   `set_union`       <- `_union_kernel` (:218), launched by
//       `sorted_union_columnar_fused` (pallas_call at :334);
//   `bucketed_union`  <- `_make_bucketed_union_kernel` (:1003, body
//       `_bucketed_union_body` :932), launched by `bucketed_union_columnar`
//       (pallas_call at :1070);
//   `set_merge`       <- `_merge_kernel` (:87), launched by
//       `bitonic_merge_columnar` (pallas_call at :120).
//
// What they compute, per lane j (planes are (C, L) int32, row-major, lane j
// = column j; keys ascending per lane with a SENTINEL tail, values 0 there):
//   set_union: the union of A's and B's C rows: keys ascending, a key held
//     by both sides appears once with its values OR-combined, a SENTINEL
//     key is padding; the first `out` rows are written and rows past the
//     unique count are SENTINEL / 0; n_unique[j] is the unique count before
//     truncation.
//   bucketed_union: each lane is B buckets of Wb rows, each ascending with
//     its own SENTINEL tail; bucket b of the output (`out_r` rows) is the
//     union of A's and B's bucket b, as above; n_unique[j] and
//     bucket_max[j] are the sum and the maximum of the buckets' unique
//     counts before truncation.
//   set_merge: the 2C rows of A and B in ascending key order, nothing
//     dropped; of two equal keys (padding included) A's copy comes first.
// The unions follow the plain twins' rule row for row (a merged row equal
// to the row before it, and not padding, ORs its values into that row and
// is dropped), so they are bit-identical to the twins, and on inputs that
// keep the host contract (unique keys per side) to the TPU kernels, whose
// bitonic network leaves the order of equal keys open but whose OR makes
// the kept copy a | b either way.  Values of any width are OR-ed exactly
// (the TPU kernels fold them into bits 16-30 of a displacement word and so
// take values < 2^15 only).  The merge equals the TPU merge wherever the
// two copies of an equal key carry equal values.
//
// Two bodies, chosen by the host (ops/hopper_union.py), which also works
// out each launch's plan and shared memory and passes them in:
//   * set_union and set_merge run the lane-tile union of tile_union.cuh at
//     one key word and one value plane (persistent CTAs of 8-lane tiles,
//     the next tile's keys in flight by cp.async while this one ranks by
//     merge path and moves, whole rows stored); set_merge in its keep-all
//     mode, whose 16-bit map leaves room for two key stages at C = 1024
//     (hopper_union.set_union_plan / merge_plan).
//   * bucketed_union runs the wide-lane segment body below: a bucket is
//     only Wb rows, so a CTA stages one bucket of W adjacent lanes at once
//     (W up to 256) and its row requests are W lanes wide — 512 B to 1 KB
//     where the lane tile's were 16-32 B.
//
// What bounds them on this card: bytes in principle (kernel 3 at C = 1024,
// out = Wb reads 4 planes and writes 2 planes of C rows: 24 KB a lane,
// 0.96 ms at 131,072 lanes and 3.35 TB/s), and in fact the rate at which an
// SM serves row requests when a lane's rows are L words apart (PERF.md,
// the kernel table): the lane tile makes its rows one 32 B sector each;
// the segment body makes them W lanes wide.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_ring.cuh"
#include "tile_union.cuh"

namespace {

// ---- the wide-lane segment body (kernel 3) ----
//
// One CTA of kThreads threads takes W adjacent lanes (W a power of two, 1 to
// 256) and walks the B buckets in order through a ring of `stages` buffers,
// each one bucket of the four input planes laid out [plane][row][lane]
// (4 x Wb x W words), filled by cp.async (the loader of segment_ring.cuh,
// shared with kernel 8's walk in set_floor.cu): 16 B a thread where W % 4 == 0,
// L % 4 == 0 and the planes are 16 B aligned, else 4 B; lanes past L read
// nothing.  While bucket b's buffer is ranked, buckets b+1 .. b+stages-1 are
// in flight.  Thread t < W unions lane t's bucket from its own column (no
// bank conflicts: neighbouring threads read neighbouring words), by a merge
// walk of the twin's rule into an output buffer [plane][row][lane] of
// out_r rows, then the whole CTA stores that buffer as whole W-lane rows
// (16 B a thread where allowed).  n_unique and bucket_max stay in the lane
// thread's registers until the last bucket.
// Shared memory (words): stages x 4 x Wb x W inputs + 2 x out_r x W outputs
// — the host's hopper_union.bucketed_union_plan; the launcher checks the
// figure it is given against this layout.

constexpr int32_t kSentinel = 0x7FFFFFFF;
constexpr int kThreads = segment_ring::kThreads;
constexpr int kMaxWidth = segment_ring::kMaxWidth;
constexpr int kMaxStages = segment_ring::kMaxStages;

struct SegArgs {
  const int32_t* ka;  // inputs (c, lanes): keys and values of A and B
  const int32_t* va;
  const int32_t* kb;
  const int32_t* vb;
  int32_t* ko;        // outputs (B * out_r, lanes)
  int32_t* vo;
  int32_t* n_unique;
  int32_t* bucket_max;
  int c;        // rows of each input plane: B * Wb
  int lanes;
  int wb;       // rows of a bucket, a power of two
  int out_r;    // output rows of a bucket, 0 .. 2 Wb
  int width;    // lanes a CTA, a power of two <= kMaxWidth
  int stages;   // input buffers, 1 .. kMaxStages
};

size_t seg_smem_bytes(const SegArgs& p) {
  return sizeof(int32_t) * (size_t)p.width *
         ((size_t)p.stages * 4 * p.wb + (size_t)2 * p.out_r);
}

// The union of one lane's bucket (column `t` of `buf`) into column `t` of
// the output buffer; returns the bucket's unique count before truncation.
__device__ __forceinline__ int union_column(const SegArgs& p, const int32_t* buf,
                                            int32_t* ko, int32_t* vo, int t) {
  const int wb = p.wb, w = p.width, out_r = p.out_r;
  const int32_t* ka = buf + t;
  const int32_t* va = ka + (size_t)wb * w;
  const int32_t* kb = va + (size_t)wb * w;
  const int32_t* vb = kb + (size_t)wb * w;
  int ia = 0, ib = 0, o = 0;
  int32_t ha = ka[0], hb = kb[0], prev = 0;
  bool prev_kept = false;  // the merged row before this one was kept
  for (int d = 0; d < 2 * wb; ++d) {
    const bool ta = ia < wb && (ib >= wb || !(hb < ha));
    const int32_t key = ta ? ha : hb;
    if (key == kSentinel) break;  // padding: every later merged row is too
    const int32_t val = ta ? va[ia * w] : vb[ib * w];
    if (ta) {
      if (++ia < wb) ha = ka[ia * w];
    } else {
      if (++ib < wb) hb = kb[ib * w];
    }
    if (d > 0 && key == prev) {  // a duplicate ORs into a kept row before it
      if (prev_kept && o - 1 < out_r) vo[(o - 1) * w + t] |= val;
      prev_kept = false;
    } else {
      if (o < out_r) {
        ko[o * w + t] = key;
        vo[o * w + t] = val;
      }
      ++o;
      prev_kept = true;
    }
    prev = key;
  }
  for (int r = o; r < out_r; ++r) {
    ko[r * w + t] = kSentinel;
    vo[r * w + t] = 0;
  }
  return o;
}

// Store the output buffer (2 planes x out_r rows x W lanes) as bucket `b`
// of the output planes, whole W-lane rows.
__device__ __forceinline__ void store_bucket(const SegArgs& p, int b, const int32_t* obuf,
                                             long long lane0, bool vec, int w_shift) {
  const int q_shift = vec ? w_shift - 2 : w_shift;
  const int chunk = vec ? 4 : 1;
  const long long lanes = p.lanes;
  const int items = (2 * p.out_r) << q_shift;
  for (int w = threadIdx.x; w < items; w += kThreads) {
    const int h = w & ((1 << q_shift) - 1), rest = w >> q_shift;
    const int plane = rest >= p.out_r, row = rest - plane * p.out_r;
    const long long lane = lane0 + h * chunk;
    if (lane >= lanes) continue;
    const int32_t* src = obuf + (size_t)rest * p.width + h * chunk;
    int32_t* dst = (plane ? p.vo : p.ko) + ((size_t)b * p.out_r + row) * lanes + lane;
    if (vec) {
      *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
    } else {
      *dst = *src;
    }
  }
}

__global__ void __launch_bounds__(kThreads) segment_union_kernel(SegArgs p) {
  extern __shared__ int32_t smem[];
  const int t = threadIdx.x, w = p.width;
  const int wb_shift = __ffs(p.wb) - 1, w_shift = __ffs(w) - 1;
  const int n_buckets = p.c >> wb_shift;
  const long long lane0 = (long long)blockIdx.x * w;
  const size_t stage_words = (size_t)4 * p.wb * w;
  int32_t* obuf = smem + p.stages * stage_words;
  const bool vec_ok = w % 4 == 0 && p.lanes % 4 == 0;
  const bool vec_in = vec_ok && ((reinterpret_cast<uintptr_t>(p.ka) | reinterpret_cast<uintptr_t>(p.va) |
                                  reinterpret_cast<uintptr_t>(p.kb) | reinterpret_cast<uintptr_t>(p.vb)) &
                                 15) == 0;
  const bool vec_out =
      vec_ok && ((reinterpret_cast<uintptr_t>(p.ko) | reinterpret_cast<uintptr_t>(p.vo)) & 15) == 0;
  const bool lane_live = t < w && lane0 + t < p.lanes;

  for (int s = 0; s < p.stages; ++s) {
    if (s < n_buckets) {
      segment_ring::load_bucket(p, s, smem + s * stage_words, lane0, vec_in, wb_shift, w_shift);
    }
    tile_union::cp_async_commit();
  }
  int total = 0, most = 0;
  for (int b = 0; b < n_buckets; ++b) {
    const int slot = b % p.stages;
    segment_ring::cp_async_wait_dyn(p.stages - 1);
    __syncthreads();  // bucket b has landed; the last bucket's stores have read obuf
    if (lane_live) {
      const int u = union_column(p, smem + slot * stage_words, obuf,
                                 obuf + (size_t)p.out_r * w, t);
      total += u;
      most = max(most, u);
    }
    __syncthreads();
    store_bucket(p, b, obuf, lane0, vec_out, w_shift);
    if (b + p.stages < n_buckets) {
      segment_ring::load_bucket(p, b + p.stages, smem + slot * stage_words, lane0, vec_in,
                                wb_shift, w_shift);
    }
    tile_union::cp_async_commit();
  }
  tile_union::cp_async_wait<0>();
  if (lane_live) {
    p.n_unique[lane0 + t] = total;
    p.bucket_max[lane0 + t] = most;
  }
}

cudaError_t launch_segment(const SegArgs& p, int smem, cudaStream_t stream) {
  const bool pow2_wb = p.wb >= 1 && (p.wb & (p.wb - 1)) == 0;
  const bool pow2_w = p.width >= 1 && p.width <= kMaxWidth && (p.width & (p.width - 1)) == 0;
  if (!pow2_wb || !pow2_w || p.c < p.wb || p.c % p.wb != 0 || p.lanes <= 0 || p.out_r < 0 ||
      p.out_r > 2 * p.wb || p.stages < 1 || p.stages > kMaxStages ||
      p.n_unique == nullptr || p.bucket_max == nullptr || smem < 0 ||
      (size_t)smem < seg_smem_bytes(p)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      segment_union_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = ((long long)p.lanes + p.width - 1) / p.width;
  segment_union_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

tile_union::Args tile_args(const void* ka, const void* va, const void* kb, const void* vb,
                           void* ko, void* vo, void* n_unique, int c, int lanes, int out,
                           int lane_tile, int stages, int stage_vals) {
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
  t.out_size = out;
  t.n_keys = 1;
  t.n_vals = 1;
  t.lt = lane_tile;
  t.stages = stages;
  t.stage_vals = stage_vals;
  return t;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` with the host's plan and `smem` bytes of
// shared memory a CTA (checked against the body's layout) and returns a
// cudaError_t.  Planes are contiguous (c, lanes) int32.

// Kernel 2: the union cut to `out` rows, on the lane tile (`lane_tile`,
// `stages`, `stage_vals`: hopper_union.set_union_plan).
int set_union(const void* ka, const void* va, const void* kb, const void* vb, void* ko,
              void* vo, void* n_unique, int c, int lanes, int out, int lane_tile,
              int stages, int stage_vals, int smem, void* stream) {
  return tile_union::launch<1>(tile_args(ka, va, kb, vb, ko, vo, n_unique, c, lanes, out,
                                         lane_tile, stages, stage_vals),
                               smem, static_cast<cudaStream_t>(stream));
}

// Kernel 6: the merge into (2c, lanes) planes, on the lane tile's keep-all
// mode (hopper_union.merge_plan).
int set_merge(const void* ka, const void* va, const void* kb, const void* vb, void* ko,
              void* vo, int c, int lanes, int lane_tile, int stages, int stage_vals,
              int smem, void* stream) {
  return tile_union::launch<1, true>(tile_args(ka, va, kb, vb, ko, vo, nullptr, c, lanes,
                                               2 * c, lane_tile, stages, stage_vals),
                                     smem, static_cast<cudaStream_t>(stream));
}

// Kernel 3: the union of each of c / wb buckets cut to `out_r` rows, into
// (c / wb * out_r, lanes) planes, on the segment body (`width` lanes a CTA,
// `stages` input buffers: hopper_union.bucketed_union_plan).
int bucketed_union(const void* ka, const void* va, const void* kb, const void* vb,
                   void* ko, void* vo, void* n_unique, void* bucket_max, int c, int lanes,
                   int wb, int out_r, int width, int stages, int smem, void* stream) {
  SegArgs p = {};
  p.ka = static_cast<const int32_t*>(ka);
  p.va = static_cast<const int32_t*>(va);
  p.kb = static_cast<const int32_t*>(kb);
  p.vb = static_cast<const int32_t*>(vb);
  p.ko = static_cast<int32_t*>(ko);
  p.vo = static_cast<int32_t*>(vo);
  p.n_unique = static_cast<int32_t*>(n_unique);
  p.bucket_max = static_cast<int32_t*>(bucket_max);
  p.c = c;
  p.lanes = lanes;
  p.wb = wb;
  p.out_r = out_r;
  p.width = width;
  p.stages = stages;
  return launch_segment(p, smem, static_cast<cudaStream_t>(stream));
}

const char* set_union_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
