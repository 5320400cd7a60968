// Fused lexN sorted-set union over columnar planes — the Hopper (sm_90a)
// port of the TPU kernel `_make_lexn_union_kernel`
// (crdt_tpu/ops/pallas_union.py:353, launched by
// `sorted_union_columnar_fused_lexn`, pallas_call at :465; its OpLog
// instance is `sorted_union_columnar_fused_lex2`, :809).
//
// What it computes, per lane j (one replica's log; planes are (C, L) int32,
// row-major, lane j = column j):
//   1. merge A's C rows with B's C rows, both ascending over the n_keys
//      lexicographic key words, carrying the n_vals value planes;
//   2. duplicate punch: a row is a duplicate when key word 0 != SENTINEL
//      and every key word equals the previous row's; the duplicate's value
//      planes OR into the kept (first) copy, and the duplicate becomes a
//      hole (OR-combine-then-keep-first);
//   3. n_unique = rows that are not holes, counted before truncation;
//   4. compaction of the kept rows to the head of the column;
//   5. the first `out_size` rows are written; rows past the unique count
//      are SENTINEL in every key word and 0 in every value plane.
// The output is bit-identical to the TPU kernel's on every plane: with
// unique keys per input, the two copies of a duplicate carry a | b
// whichever copy the merge puts first.
//
// Design (a simple, correct first version):
//   * one CTA per lane; the lane's key words of A and B go to shared
//     memory, and the merge is a merge-path rank: A[i] lands at
//     i + #(B < A[i]), B[j] at j + #(A <= B[j]) — a binary search each, no
//     bitonic network and no per-stage barrier, and B is read in its own
//     ascending order (the TPU wrapper's flip of B is a Mosaic artefact);
//   * the merged planes sit in dynamic shared memory:
//     2·n_keys·C + 2C·(n_keys+n_vals) words plus 2C flag bytes — 50.3 KB
//     at C=1024 for (2, 2), above the 48 KB default, so the launcher opts
//     in with cudaFuncSetAttribute (the wrapper checks the 227 KB limit);
//   * compaction is one block-wide exclusive scan of the keep flags (each
//     thread owns a run of consecutive rows) and a scatter straight to
//     device memory — the TPU's log-step shift network is not needed.
//
// What bounds it on this card: bytes.  At C=1024, L=10,240 one merge reads
// 8 planes x C x L x 4 B = 335.5 MB and writes 4 x C x L x 4 B + 4L B =
// 167.8 MB; at 3.35 TB/s that is 0.150 ms, against ~(C log C) integer
// compares per lane, which the card does far faster.  This version reads
// each lane's column strided by L, so a warp's load touches 32 sectors and
// uses 4 B of each 32 B sector; neighbouring lanes run on neighbouring
// CTAs and mostly hit in L2, but the access pattern is not coalesced.
// The fix (lane tiles of 8-32 lanes per CTA with coalesced transposed
// loads, or TMA tiles) is left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kSentinel = 0x7FFFFFFF;
constexpr int kMaxPlanes = 8;  // per operand: n_keys + n_vals <= 8
constexpr int kThreads = 256;

struct Params {
  const int32_t* a[kMaxPlanes];
  const int32_t* b[kMaxPlanes];
  int32_t* out[kMaxPlanes];
  int32_t* n_unique;
  int c;
  int lanes;
  int out_size;
};

// x < y over NK words, x at column xi of a plane set with row stride xs.
template <int NK>
__device__ __forceinline__ bool lex_less(const int32_t* x, int xs, int xi,
                                         const int32_t* y, int ys, int yi) {
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int32_t u = x[k * xs + xi], v = y[k * ys + yi];
    if (u != v) return u < v;
  }
  return false;
}

// #rows of `arr` (n rows, ascending) strictly below element `xi` of `x`
// (strict = true), or at or below it (strict = false).
template <int NK, bool kStrict>
__device__ __forceinline__ int rank_in(const int32_t* arr, int n,
                                       const int32_t* x, int xi) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool go_right = kStrict ? lex_less<NK>(arr, n, mid, x, n, xi)
                                  : !lex_less<NK>(x, n, xi, arr, n, mid);
    if (go_right) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <int NK, int NV>
__global__ void __launch_bounds__(kThreads)
lexn_union_kernel(Params p) {
  constexpr int NP = NK + NV;
  extern __shared__ int32_t smem[];
  const int c = p.c, n = 2 * c;
  const size_t lanes = (size_t)p.lanes;
  const size_t lane = blockIdx.x;

  int32_t* sa = smem;                   // NK x C   A's key words
  int32_t* sb = sa + NK * c;            // NK x C   B's key words
  int32_t* m = sb + NK * c;             // NP x 2C  merged planes
  int* warp_sums = m + NP * n;          // 32
  unsigned char* dup = reinterpret_cast<unsigned char*>(warp_sums + 32);  // 2C

  for (int i = threadIdx.x; i < c; i += blockDim.x) {
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      sa[k * c + i] = p.a[k][i * lanes + lane];
      sb[k * c + i] = p.b[k][i * lanes + lane];
    }
  }
  __syncthreads();

  // 1. merge by rank: equal keys put A's copy first.
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    const int pa = i + rank_in<NK, true>(sb, c, sa, i);
    const int pb = i + rank_in<NK, false>(sa, c, sb, i);
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      m[k * n + pa] = sa[k * c + i];
      m[k * n + pb] = sb[k * c + i];
    }
#pragma unroll
    for (int v = NK; v < NP; ++v) {
      m[v * n + pa] = p.a[v][i * lanes + lane];
      m[v * n + pb] = p.b[v][i * lanes + lane];
    }
  }
  __syncthreads();

  // 2a. duplicate flags (read-only over m).
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    bool d = r > 0 && m[r] != kSentinel;
#pragma unroll
    for (int k = 0; k < NK; ++k) d = d && m[k * n + r] == m[k * n + r - 1];
    dup[r] = d;
  }
  __syncthreads();

  // 2b. OR each duplicate's values into its kept copy.  Only kept rows are
  // written and only duplicate rows are read, so no row is both.
  for (int r = threadIdx.x; r + 1 < n; r += blockDim.x) {
    if (!dup[r] && dup[r + 1]) {
#pragma unroll
      for (int v = NK; v < NP; ++v) m[v * n + r] |= m[v * n + r + 1];
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
  const int total = warp_sums[n_warps - 1];
  int dst = incl - cnt + (wid > 0 ? warp_sums[wid - 1] : 0);

  // 4-5. scatter kept rows to their compacted row, truncated to out_size.
  for (int r = r0; r < r1 && dst < p.out_size; ++r) {
    if (dup[r] || m[r] == kSentinel) continue;
#pragma unroll
    for (int v = 0; v < NP; ++v) p.out[v][dst * lanes + lane] = m[v * n + r];
    ++dst;
  }
  for (int r = total + threadIdx.x; r < p.out_size; r += blockDim.x) {
#pragma unroll
    for (int v = 0; v < NP; ++v) p.out[v][r * lanes + lane] = v < NK ? kSentinel : 0;
  }
  if (threadIdx.x == 0) p.n_unique[lane] = total;
}

template <int NK, int NV>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  auto kernel = lexn_union_kernel<NK, NV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.lanes, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs (the wrapper checks the card's limit).
size_t lexn_union_smem_bytes(int n_keys, int n_vals, int c) {
  const size_t n = 2 * (size_t)c;
  return sizeof(int32_t) * (2 * (size_t)n_keys * c + (n_keys + n_vals) * n + 32) + n;
}

// Launch the union on `stream`.  Pointer arrays hold n_keys + n_vals
// device pointers each (keys first); planes are contiguous (C, lanes)
// int32, outputs (out_size, lanes), n_unique (lanes,).  Returns a
// cudaError_t; cudaErrorInvalidValue for a plane split with no
// instantiation.
int lexn_union(int n_keys, int n_vals, const void* const* a,
               const void* const* b, void* const* out, void* n_unique, int c,
               int lanes, int out_size, void* stream) {
  if (n_keys + n_vals > kMaxPlanes || lanes <= 0) return cudaErrorInvalidValue;
  Params p = {};
  for (int i = 0; i < n_keys + n_vals; ++i) {
    p.a[i] = static_cast<const int32_t*>(a[i]);
    p.b[i] = static_cast<const int32_t*>(b[i]);
    p.out[i] = static_cast<int32_t*>(out[i]);
  }
  p.n_unique = static_cast<int32_t*>(n_unique);
  p.c = c;
  p.lanes = lanes;
  p.out_size = out_size;
  const size_t smem = lexn_union_smem_bytes(n_keys, n_vals, c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_keys == 2 && n_vals == 2) return launch<2, 2>(p, smem, s);
  return cudaErrorInvalidValue;
}

const char* lexn_union_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
