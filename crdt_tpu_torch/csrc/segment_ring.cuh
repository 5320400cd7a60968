// The wide-lane segment ring: the loader shared by the two bodies that walk
// a lane's buckets in order — kernel 3's bucket-local union (set_union.cu,
// `segment_union_kernel`) and kernel 8's bucketed floor (set_floor.cu,
// `floor_walk_kernel`).
//
// A CTA of kThreads threads takes W adjacent lanes (W a power of two, 1 to
// 256) and keeps a ring of bucket buffers, each one bucket of the four input
// planes laid out [plane][row][lane] (4 x Wb x W words; planes in the order
// keys A, values A, keys B, values B), filled by cp.async: 16 B a thread
// where the caller allows it (W % 4 == 0, L % 4 == 0, planes on 16 B), else
// 4 B; lanes past L read nothing and fill zeros.  A row request is then W
// lanes wide: 1 KB at 256 lanes, where an 8-lane tile's is one 32 B sector.
// Thread t reads lane t's bucket from its own column: neighbouring threads
// read neighbouring words, so the column reads have no bank conflicts.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_union.cuh"

namespace segment_ring {

constexpr int kThreads = 256;
constexpr int kMaxWidth = 256;
constexpr int kMaxStages = 4;

__device__ __forceinline__ void cp_async_wait_dyn(int pending) {
  switch (pending) {
    case 0: tile_union::cp_async_wait<0>(); break;
    case 1: tile_union::cp_async_wait<1>(); break;
    case 2: tile_union::cp_async_wait<2>(); break;
    default: tile_union::cp_async_wait<3>(); break;
  }
}

// Request bucket `b` of the four input planes for lanes lane0 .. lane0+W-1
// into `buf` ([plane][row][lane]).  `P` has the planes (ka, va, kb, vb),
// `lanes`, `wb` (rows of a bucket, a power of two) and `width` (W).
template <class P>
__device__ __forceinline__ void load_bucket(const P& p, int b, int32_t* buf,
                                            long long lane0, bool vec, int wb_shift,
                                            int w_shift) {
  const int q_shift = vec ? w_shift - 2 : w_shift;  // chunks a row, log2
  const int chunk = vec ? 4 : 1;                    // lanes a chunk
  const long long lanes = p.lanes;
  const int items = 4 << (wb_shift + q_shift);
  for (int w = threadIdx.x; w < items; w += kThreads) {
    const int h = w & ((1 << q_shift) - 1), rest = w >> q_shift;
    const int row = rest & (p.wb - 1), plane = rest >> wb_shift;
    const long long lane = lane0 + h * chunk;
    const long long left = lanes - lane;
    const int valid = left <= 0 ? 0 : (left >= chunk ? chunk : (int)left);
    int32_t* dst = buf + ((size_t)(plane << wb_shift) + row) * p.width + h * chunk;
    // a select, not p.in[plane]: indexing the parameters would copy them to
    // the stack
    const int32_t* base = plane < 2 ? (plane ? p.va : p.ka) : (plane == 2 ? p.kb : p.vb);
    const int32_t* src = valid ? base + ((size_t)b * p.wb + row) * lanes + lane : base;
    if (vec) tile_union::cp_async16(dst, src, 4 * valid);
    else tile_union::cp_async4(dst, src, 4 * valid);
  }
}

}  // namespace segment_ring
