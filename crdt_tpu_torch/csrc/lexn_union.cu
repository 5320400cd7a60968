// LexN sorted-set unions over columnar planes — the Hopper (sm_90a) ports of
// three TPU kernels of crdt_tpu/ops/pallas_union.py:
//
//   lexn_union    `_make_lexn_union_kernel` (:353, pallas_call :465 in
//                 `sorted_union_columnar_fused_lexn` :421; its OpLog
//                 instance is `sorted_union_columnar_fused_lex2` :809);
//   lexn_merge    `_make_lexn_merge_kernel` (:492, pallas_call :537 in
//                 `lexn_merge_columnar` :524) — merge only, the merge-split
//                 primitive of the capacity-striped union;
//   lexn_compact  `_make_lexn_compact_kernel` (:557, pallas_call :604 in
//                 `lexn_compact_columnar` :587) — the duplicate punch,
//                 compaction and truncation after the striped merge.
//
// Planes are (rows, L) int32, row-major, lane j = column j (one replica's
// table); rows ascend lexicographically over the n_keys key words; padding
// rows are SENTINEL in every key word and 0 in every value plane.
//
// lexn_union, per lane:
//   1. merge A's C rows with B's C rows, carrying the n_vals value planes;
//   2. duplicate punch: a row is a duplicate when key word 0 != SENTINEL
//      and every key word equals the previous row's; the duplicate's value
//      planes OR into the kept (first) copy, and the duplicate becomes a
//      hole (OR-combine-then-keep-first);
//   3. n_unique = rows that are not holes, counted before truncation;
//   4. compaction of the kept rows to the head of the column;
//   5. the first `out_size` rows are written; rows past the unique count
//      are SENTINEL in every key word and 0 in every value plane.
// lexn_merge is step 1 alone (the exact sorted 2S-row multiset, nothing
// dropped); lexn_compact is steps 2-5 over rows that are already sorted.
// With unique keys per input, the two copies of a duplicate carry a | b
// whichever copy comes first, so the union's output is bit-identical to the
// TPU kernels' on every plane.  The raw merge is not: of two equal keys it
// always puts A's copy first, where the TPU's bitonic network puts either.
//
// Design (a simple, correct first version, one CTA per lane):
//   * merge by rank: the lane's key words of A and B go to shared memory,
//     A[i] lands at i + #(B < A[i]), B[j] at j + #(A <= B[j]) — a binary
//     search each, no bitonic network and no per-stage barrier, B read in
//     its own ascending order (the TPU wrapper's flip of B is a Mosaic
//     artefact);
//   * lexn_union keeps the merged planes in dynamic shared memory:
//     2·n_keys·C + 2C·(n_keys+n_vals) words plus 2C flag bytes — 50.3 KB
//     at C=1024 for (2, 2), 156,800 B at C=512 for RSeq's (18, 2); past the
//     card's 227 KB opt-in the host code stripes the union instead;
//   * lexn_merge stages only the key words (2·n_keys·S words: 147,456 B at
//     S=1024, n_keys=18) and writes every plane of a row straight to its
//     merged row in device memory;
//   * lexn_compact keeps only one flag byte a row and the scan in shared
//     memory (2C + 128 B), reading keys and values from device memory, so
//     it has no capacity ceiling below 2C = 232,320 rows;
//   * compaction is one block-wide exclusive scan of the keep flags (each
//     thread owns a run of consecutive rows) and a scatter straight to
//     device memory — the TPU's log-step shift network is not needed.
//   * the key and value counts are run-time arguments (under kMaxPlanes
//     planes a side), so every split — the OpLog's (2, 2), RSeq's at any
//     depth up to 9 — runs one instantiation.
//
// What bounds them on this card: bytes.  At C=1024, L=10,240 the OpLog
// union reads 8 planes x C x L x 4 B = 335.5 MB and writes 167.8 MB: 0.150
// ms at 3.35 TB/s, against ~(C log C) integer compares a lane, which the
// card does far faster.  RSeq's 20-plane merge moves 3.36 GB (1.00 ms) and
// its compaction 2.52 GB (0.75 ms).  These versions read each lane's column
// strided by L, so a warp's load touches 32 sectors and uses 4 B of each
// 32 B sector; neighbouring lanes run on neighbouring CTAs and mostly hit
// in L2, but the access pattern is not coalesced.  The fix (lane tiles with
// coalesced transposed loads, or TMA tiles) is left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kSentinel = 0x7FFFFFFF;
constexpr int kMaxPlanes = 32;  // per operand: n_keys + n_vals <= 32
constexpr int kThreads = 256;

struct Params {
  const int32_t* a[kMaxPlanes];
  const int32_t* b[kMaxPlanes];
  int32_t* out[kMaxPlanes];
  int32_t* n_unique;
  int c;         // rows of each input plane
  int lanes;
  int out_size;  // rows of each output plane
  int n_keys;
  int n_vals;
};

// x < y over nk words, x at column xi of a plane set with row stride xs.
__device__ __forceinline__ bool lex_less(const int32_t* x, int xs, int xi,
                                         const int32_t* y, int ys, int yi,
                                         int nk) {
  for (int k = 0; k < nk; ++k) {
    const int32_t u = x[k * xs + xi], v = y[k * ys + yi];
    if (u != v) return u < v;
  }
  return false;
}

// #rows of `arr` (n rows, ascending) strictly below element `xi` of `x`
// (strict = true), or at or below it (strict = false).
template <bool kStrict>
__device__ __forceinline__ int rank_in(const int32_t* arr, int n,
                                       const int32_t* x, int xi, int nk) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool go_right = kStrict ? lex_less(arr, n, mid, x, n, xi, nk)
                                  : !lex_less(x, n, xi, arr, n, mid, nk);
    if (go_right) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Stage the lane's key words of A and B in shared memory (nk x c each).
__device__ __forceinline__ void stage_keys(const Params& p, int32_t* sa,
                                           int32_t* sb) {
  const size_t lanes = (size_t)p.lanes, lane = blockIdx.x;
  for (int i = threadIdx.x; i < p.c; i += blockDim.x) {
    for (int k = 0; k < p.n_keys; ++k) {
      sa[k * p.c + i] = p.a[k][i * lanes + lane];
      sb[k * p.c + i] = p.b[k][i * lanes + lane];
    }
  }
}

// Block-wide exclusive scan of `cnt` (one count per thread, threads in
// order).  Returns the thread's exclusive prefix; *total gets the sum.
__device__ __forceinline__ int block_exclusive_scan(int cnt, int* warp_sums,
                                                    int* total) {
  const int wid = threadIdx.x >> 5, lid = threadIdx.x & 31;
  const int n_warps = (blockDim.x + 31) >> 5;
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lid >= o) incl += y;
  }
  if (lid == 31) warp_sums[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int w = lid < n_warps ? warp_sums[lid] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lid >= o) w += y;
    }
    if (lid < n_warps) warp_sums[lid] = w;
  }
  __syncthreads();
  *total = warp_sums[n_warps - 1];
  return incl - cnt + (wid > 0 ? warp_sums[wid - 1] : 0);
}

__global__ void __launch_bounds__(kThreads)
lexn_union_kernel(Params p) {
  const int nk = p.n_keys, np = p.n_keys + p.n_vals;
  extern __shared__ int32_t smem[];
  const int c = p.c, n = 2 * c;
  const size_t lanes = (size_t)p.lanes;
  const size_t lane = blockIdx.x;

  int32_t* sa = smem;                   // nk x C   A's key words
  int32_t* sb = sa + nk * c;            // nk x C   B's key words
  int32_t* m = sb + nk * c;             // np x 2C  merged planes
  int* warp_sums = m + np * n;          // 32
  unsigned char* dup = reinterpret_cast<unsigned char*>(warp_sums + 32);  // 2C

  stage_keys(p, sa, sb);
  __syncthreads();

  // 1. merge by rank: equal keys put A's copy first.
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    const int pa = i + rank_in<true>(sb, c, sa, i, nk);
    const int pb = i + rank_in<false>(sa, c, sb, i, nk);
    for (int k = 0; k < nk; ++k) {
      m[k * n + pa] = sa[k * c + i];
      m[k * n + pb] = sb[k * c + i];
    }
    for (int v = nk; v < np; ++v) {
      m[v * n + pa] = p.a[v][i * lanes + lane];
      m[v * n + pb] = p.b[v][i * lanes + lane];
    }
  }
  __syncthreads();

  // 2a. duplicate flags (read-only over m).
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    bool d = r > 0 && m[r] != kSentinel;
    for (int k = 0; d && k < nk; ++k) d = m[k * n + r] == m[k * n + r - 1];
    dup[r] = d;
  }
  __syncthreads();

  // 2b. OR each duplicate's values into its kept copy.  Only kept rows are
  // written and only duplicate rows are read, so no row is both.
  for (int r = threadIdx.x; r + 1 < n; r += blockDim.x) {
    if (!dup[r] && dup[r + 1]) {
      for (int v = nk; v < np; ++v) m[v * n + r] |= m[v * n + r + 1];
    }
  }
  __syncthreads();

  // 3. block-wide exclusive scan of keep flags; thread t owns rows
  // [t·per, (t+1)·per).
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int r0 = threadIdx.x * per;
  const int r1 = min(r0 + per, n);
  int cnt = 0;
  for (int r = r0; r < r1; ++r) cnt += !dup[r] && m[r] != kSentinel;
  int total;
  int dst = block_exclusive_scan(cnt, warp_sums, &total);

  // 4-5. scatter kept rows to their compacted row, truncated to out_size.
  for (int r = r0; r < r1 && dst < p.out_size; ++r) {
    if (dup[r] || m[r] == kSentinel) continue;
    for (int v = 0; v < np; ++v) p.out[v][dst * lanes + lane] = m[v * n + r];
    ++dst;
  }
  for (int r = total + threadIdx.x; r < p.out_size; r += blockDim.x) {
    for (int v = 0; v < np; ++v) p.out[v][r * lanes + lane] = v < nk ? kSentinel : 0;
  }
  if (threadIdx.x == 0) p.n_unique[lane] = total;
}

// Merge only: lane j of the (2S, L) output planes is the sorted merge of
// A's and B's S rows, every plane carried, A's copy of an equal key first.
__global__ void __launch_bounds__(kThreads)
lexn_merge_kernel(Params p) {
  const int nk = p.n_keys, np = p.n_keys + p.n_vals;
  extern __shared__ int32_t smem[];
  const int s = p.c;
  const size_t lanes = (size_t)p.lanes;
  const size_t lane = blockIdx.x;
  int32_t* sa = smem;         // nk x S   A's key words
  int32_t* sb = sa + nk * s;  // nk x S   B's key words

  stage_keys(p, sa, sb);
  __syncthreads();

  for (int i = threadIdx.x; i < s; i += blockDim.x) {
    const size_t pa = i + rank_in<true>(sb, s, sa, i, nk);
    const size_t pb = i + rank_in<false>(sa, s, sb, i, nk);
    for (int k = 0; k < nk; ++k) {
      p.out[k][pa * lanes + lane] = sa[k * s + i];
      p.out[k][pb * lanes + lane] = sb[k * s + i];
    }
    for (int v = nk; v < np; ++v) {
      p.out[v][pa * lanes + lane] = p.a[v][i * lanes + lane];
      p.out[v][pb * lanes + lane] = p.b[v][i * lanes + lane];
    }
  }
}

// Duplicate punch + compaction + truncation over sorted (n, L) planes
// (p.a, n = p.c rows) into (out_size, L) planes and n_unique (L).
__global__ void __launch_bounds__(kThreads)
lexn_compact_kernel(Params p) {
  const int nk = p.n_keys, np = p.n_keys + p.n_vals;
  extern __shared__ int32_t smem[];
  const int n = p.c;
  const size_t lanes = (size_t)p.lanes;
  const size_t lane = blockIdx.x;
  int* warp_sums = smem;                                                    // 32
  unsigned char* flag = reinterpret_cast<unsigned char*>(warp_sums + 32);  // n

  // flag bit 0: a duplicate of the row above; bit 1: padding (key word 0
  // is SENTINEL).  A row is kept when its flag is 0.
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const size_t row = (size_t)r * lanes + lane;
    const bool pad = p.a[0][row] == kSentinel;
    bool d = r > 0 && !pad;
    for (int k = 0; d && k < nk; ++k) d = p.a[k][row] == p.a[k][row - lanes];
    flag[r] = (d ? 1 : 0) | (pad ? 2 : 0);
  }
  __syncthreads();

  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int r0 = threadIdx.x * per;
  const int r1 = min(r0 + per, n);
  int cnt = 0;
  for (int r = r0; r < r1; ++r) cnt += flag[r] == 0;
  int total;
  int dst = block_exclusive_scan(cnt, warp_sums, &total);

  for (int r = r0; r < r1 && dst < p.out_size; ++r) {
    if (flag[r] != 0) continue;
    const size_t row = (size_t)r * lanes + lane;
    const bool next_dup = r + 1 < n && (flag[r + 1] & 1);
    const size_t to = (size_t)dst * lanes + lane;
    for (int k = 0; k < nk; ++k) p.out[k][to] = p.a[k][row];
    for (int v = nk; v < np; ++v) {
      p.out[v][to] = next_dup ? p.a[v][row] | p.a[v][row + lanes] : p.a[v][row];
    }
    ++dst;
  }
  for (int r = total + threadIdx.x; r < p.out_size; r += blockDim.x) {
    const size_t to = (size_t)r * lanes + lane;
    for (int v = 0; v < np; ++v) p.out[v][to] = v < nk ? kSentinel : 0;
  }
  if (threadIdx.x == 0) p.n_unique[lane] = total;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.lanes, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

bool fill_params(Params* p, int n_keys, int n_vals, const void* const* a,
                 const void* const* b, void* const* out, void* n_unique,
                 int c, int lanes, int out_size) {
  if (n_keys < 1 || n_vals < 0 || n_keys + n_vals > kMaxPlanes || lanes <= 0 ||
      c < 1) {
    return false;
  }
  *p = Params{};
  for (int i = 0; i < n_keys + n_vals; ++i) {
    p->a[i] = static_cast<const int32_t*>(a[i]);
    p->b[i] = b ? static_cast<const int32_t*>(b[i]) : nullptr;
    p->out[i] = static_cast<int32_t*>(out[i]);
  }
  p->n_unique = static_cast<int32_t*>(n_unique);
  p->c = c;
  p->lanes = lanes;
  p->out_size = out_size;
  p->n_keys = n_keys;
  p->n_vals = n_vals;
  return true;
}

}  // namespace

extern "C" {

// Each launcher takes `smem`, the dynamic shared memory of one CTA as the
// host computes it (crdt_tpu_torch/ops/hopper_union.py, lexn_*_smem_bytes,
// which follow the layouts above): past the card's opt-in limit
// cudaFuncSetAttribute refuses the launch.  Pointer arrays hold
// n_keys + n_vals device pointers each (keys first); planes are contiguous
// (rows, lanes) int32.  Each returns a cudaError_t,
// cudaErrorInvalidValue for a plane count past kMaxPlanes.

// The union: inputs (c, lanes), outputs (out_size, lanes), n_unique (lanes,).
int lexn_union(int n_keys, int n_vals, const void* const* a,
               const void* const* b, void* const* out, void* n_unique, int c,
               int lanes, int out_size, int smem, void* stream) {
  Params p;
  if (!fill_params(&p, n_keys, n_vals, a, b, out, n_unique, c, lanes, out_size)) {
    return cudaErrorInvalidValue;
  }
  return launch(lexn_union_kernel, p, smem, static_cast<cudaStream_t>(stream));
}

// The merge: inputs (s, lanes), outputs (2s, lanes).
int lexn_merge(int n_keys, int n_vals, const void* const* a,
               const void* const* b, void* const* out, int s, int lanes,
               int smem, void* stream) {
  Params p;
  if (!fill_params(&p, n_keys, n_vals, a, b, out, nullptr, s, lanes, 2 * s)) {
    return cudaErrorInvalidValue;
  }
  return launch(lexn_merge_kernel, p, smem, static_cast<cudaStream_t>(stream));
}

// The compaction: inputs (n, lanes) sorted per lane, outputs (out_size,
// lanes), n_unique (lanes,).
int lexn_compact(int n_keys, int n_vals, const void* const* planes,
                 void* const* out, void* n_unique, int n, int lanes,
                 int out_size, int smem, void* stream) {
  Params p;
  if (!fill_params(&p, n_keys, n_vals, planes, nullptr, out, n_unique, n, lanes,
                   out_size)) {
    return cudaErrorInvalidValue;
  }
  return launch(lexn_compact_kernel, p, smem, static_cast<cudaStream_t>(stream));
}

const char* lexn_union_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
