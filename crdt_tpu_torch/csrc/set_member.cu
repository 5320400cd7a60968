// The OR-Set member mask on Hopper (sm_90a): bool[n_universe, L] membership
// of every element id in every lane, read from the joined (C, L) key and
// removed planes of a columnar OR-Set swarm (models/orset.py
// `columnar_member_mask`).
//
// It replaces no TPU kernel.  The JAX package computes the same function
// with `jnp` `.at[].max` (crdt_tpu/models/orset.py:428), which XLA lowers
// by itself, and no `pallas_call` stands there.  It was added because the
// port's plain twin, on the card, builds the whole intermediate state in
// device memory: a valid plane, an element plane, three `torch.where`
// planes, an int64 row plane (8.6 GB at C = 1,024, L = 2^20), an int32 live
// plane and mask, then a `scatter_reduce_` over 2^30 rows and a compare.
// Each step is a pass over gigabytes: 91 ms of a 113 ms OR-Set join epoch.
//
// What it computes, per lane j (planes are (C, L) int32, row-major, lane j
// = column j; rows in any order, SENTINEL rows anywhere):
//   row c is live when packed[c, j] != SENTINEL and removed[c, j] == 0 (any
//   nonzero removed value counts as removed); its element id is
//   (packed >> elem_shift) & elem_mask, the shift arithmetic as torch's >>
//   on int32; mask[e, j] = 1 when some live row of lane j has id e, for
//   every e < n_universe, and 0 otherwise.  An id >= n_universe is dropped
//   (the spare row of the twin's table).  Every row is read: nothing relies
//   on a sorted lane or its SENTINEL tail.
//
// What bounds it on this card: bytes.  It reads both planes once and writes
// the mask once: 2 * 4 * C * L + n_universe * L bytes, 9.66 GB at C =
// n_universe = 1,024 and L = 2^20, 2.88 ms at 3.35 TB/s.  The design keeps
// everything between those reads and that write on chip:
//   * one thread a lane, a block's lanes adjacent, so a warp's load of row c
//     is 128 contiguous bytes of each plane and a block's up to 4 KB (wider
//     blocks read faster on an H100: 3.58 ms at 256 lanes, 3.15 at 1,024); the
//     row loop is unrolled by kUnroll, so 2 * kUnroll loads a thread are in
//     flight;
//   * a bitmap a lane in shared memory, min(n_universe, elem_mask + 1) bits
//     (2 KB a lane at most), word-major ([word][lane]), so that the lanes of
//     a warp hit 32 different banks; only a lane's thread sets its bits, with
//     plain stores and no atomics;
//   * after the block's barrier, the write-out: each thread writes 4
//     adjacent lanes' bytes of one mask row, one 32-bit store when L is a
//     multiple of 4 (4 byte stores otherwise), so a warp writes 128
//     contiguous bytes; rows past the bitmap are written 0.  The kernel
//     writes every byte of the mask: the host allocates it uninitialised.
// The host's plan (hopper_union.member_mask_plan) picks the lanes a block,
// a multiple of 32, from the bitmap's bytes and the shared-memory limit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kSentinel = 0x7fffffff;
// rows of a lane in flight a thread (two loads each)
constexpr int kUnroll = 8;
constexpr int kMaxLanes = 1024;

struct Args {
  const int32_t* packed;
  const int32_t* removed;
  uint8_t* mask;
  int c;
  int lanes;
  int n_universe;
  int id_rows;     // mask rows the bitmap holds: min(n_universe, elem_mask + 1)
  int elem_shift;
  int elem_mask;
  int lpb;         // lanes a block, one thread each
};

__device__ __forceinline__ void take_row(uint32_t* mine, int lpb, int32_t key, int32_t rem,
                                         const Args& p) {
  const int e = (key >> p.elem_shift) & p.elem_mask;
  if (key != kSentinel && rem == 0 && e < p.id_rows) {
    mine[(e >> 5) * lpb] |= 1u << (e & 31);
  }
}

__global__ void member_mask_kernel(const Args p) {
  extern __shared__ uint32_t bits[];  // [words][lpb]
  const int t = threadIdx.x;
  const int lpb = p.lpb;
  const int words = (p.id_rows + 31) >> 5;
  const long long lane0 = (long long)blockIdx.x * lpb;

  for (int i = t; i < words * lpb; i += lpb) bits[i] = 0;
  __syncthreads();

  const long long lane = lane0 + t;
  if (lane < p.lanes) {
    const size_t stride = (size_t)p.lanes;
    const int32_t* pk = p.packed + lane;
    const int32_t* rm = p.removed + lane;
    uint32_t* mine = bits + t;
    int c = 0;
    for (; c + kUnroll <= p.c; c += kUnroll) {
      int32_t k[kUnroll], r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        k[u] = __ldg(pk + (size_t)(c + u) * stride);
        r[u] = __ldg(rm + (size_t)(c + u) * stride);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) take_row(mine, lpb, k[u], r[u], p);
    }
    for (; c < p.c; ++c) {
      take_row(mine, lpb, __ldg(pk + (size_t)c * stride), __ldg(rm + (size_t)c * stride), p);
    }
  }
  __syncthreads();

  // write-out: a pass of the block covers 4 mask rows of its lpb lanes,
  // thread t the lanes 4g..4g+3 (g = t % groups) of row t / groups
  const int groups = lpb >> 2;
  const int g = t % groups;
  const long long first = lane0 + 4 * g;
  if (first >= p.lanes) return;
  const bool whole_words = (p.lanes & 3) == 0;
  const int n_here = (int)min(4LL, (long long)p.lanes - first);
  for (int e = t / groups; e < p.n_universe; e += 4) {
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (e < p.id_rows) w = *reinterpret_cast<const uint4*>(bits + (e >> 5) * lpb + 4 * g);
    const int s = e & 31;
    const uint32_t b = ((w.x >> s) & 1u) | ((w.y >> s) & 1u) << 8 | ((w.z >> s) & 1u) << 16 |
                       ((w.w >> s) & 1u) << 24;
    uint8_t* out = p.mask + (size_t)e * (size_t)p.lanes + first;
    if (whole_words) {
      *reinterpret_cast<uint32_t*>(out) = b;
    } else {
      for (int k = 0; k < n_here; ++k) out[k] = (uint8_t)(b >> (8 * k));
    }
  }
}

}  // namespace

extern "C" {

// The member mask into the (n_universe, lanes) bool plane `mask`, on
// `stream`, `lanes_per_block` lanes a block with `smem` bytes of shared
// memory (hopper_union.member_mask_plan); returns a cudaError_t.  `packed`
// and `removed` are contiguous (c, lanes) int32.
int member_mask(const void* packed, const void* removed, void* mask, int c, int lanes,
                int n_universe, int id_rows, int elem_shift, int elem_mask,
                int lanes_per_block, int smem, void* stream) {
  const int words = (id_rows + 31) >> 5;
  if (c < 0 || lanes <= 0 || n_universe <= 0 || id_rows < 1 || id_rows > n_universe ||
      id_rows > elem_mask + 1 || elem_shift < 0 || elem_shift > 31 || elem_mask < 0 ||
      lanes_per_block < 32 || lanes_per_block > kMaxLanes || lanes_per_block % 32 != 0 ||
      smem < 0 || (long long)smem < 4LL * words * lanes_per_block) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      member_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  Args p = {};
  p.packed = static_cast<const int32_t*>(packed);
  p.removed = static_cast<const int32_t*>(removed);
  p.mask = static_cast<uint8_t*>(mask);
  p.c = c;
  p.lanes = lanes;
  p.n_universe = n_universe;
  p.id_rows = id_rows;
  p.elem_shift = elem_shift;
  p.elem_mask = elem_mask;
  p.lpb = lanes_per_block;
  const long long blocks = ((long long)lanes + lanes_per_block - 1) / lanes_per_block;
  member_mask_kernel<<<(unsigned)blocks, lanes_per_block, smem,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

const char* set_member_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
