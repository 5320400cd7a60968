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
// What they compute, per lane j (planes are (C, L) int32, row-major, lane j =
// column j).  The lane's n = 2C rows are cut into segments of 2·seg rows
// (seg = C for floor_union, Wb = C / n_buckets for the bucketed floor);
// segment s holds A's rows [s·seg, (s+1)·seg) followed by B's same rows
// REVERSED (the TPU host flipped B before the call; these kernels read B's
// rows in reverse).  In uint32 arithmetic (sums wrap, as XLA's int32 does):
//   1. butterflies at strides seg, seg/2, ..., 1: keys (a + b, a - b),
//      values (a | b, a ^ b).  The key stages commute, the value stages do
//      not: they run strictly from the widest stride down;
//   2. the punch, over the whole lane: keys += shift_down(keys, 1,
//      SENTINEL); vals |= shift_up(vals, 1, 0); keys ^= shift_up(keys, 1, 0);
//   3. p = inclusive prefix count of keys & 1 per segment; disp = p | vals
//      << 16; nu[j] = p at the lane's last row;
//   4. a suffix sum of keys and a suffix OR of disp per segment;
//   5. out: the first out_seg rows of each segment, keys and disp >> 16
//      (arithmetic).
//
// Two facts shape both kernels.
//   (a) The planes are independent.  p <= 2·seg <= 2^14 < 2^16, so bits
//       16-31 of disp's suffix OR are the suffix OR of vals' low 16 bits:
//       the value output is that half, sign-extended, and p itself is
//       never needed; nu is the count of odd keys over the lane's last
//       segment.  So each plane is computed alone: keys (butterflies, punch,
//       suffix sum, nu), then values (butterflies, v | v_next, suffix OR).
//   (b) A butterfly network's row 0 is its segment's total: the sum of the
//       keys, the OR of the values (each stage's row 0 is a + b, a | b).
//
// What bounds them on this card: bytes.  At C = 1024 a floor reads 4 planes
// and writes 2·out + 1 rows a lane: 24 KB a lane at out = C, 3.22 GB at
// L = 131,072, 0.962 ms at 3.35 TB/s; the butterflies, punch and scans are
// 8.5 G int32 operations, 0.51 ms at 16.7 T op/s.  In practice the rate of
// row requests (a lane's rows lie L words apart) and keeping loads in
// flight while a CTA computes; the two bodies below are about that.
//
// Kernel 7, the tile body (floor_union, and the bucketed floor where a
// segment is taller than the walk takes): a lane's 2C rows all interact,
// so a CTA holds whole columns.  Persistent CTAs of 512 threads walk tiles
// of LT adjacent lanes (tile, tile + grid, ...: neighbouring CTAs on
// neighbouring tiles), LT = 512·R / 2C with R = min(32, 2C) rows a thread:
// 8 lanes at C = 1024 (each row of a plane one whole 32 B sector), 1 at
// C = 8192, the envelope's top.  A job is one plane of one tile (keys, then
// values): a ring of three plane buffers (64 KB each at R = 32) keeps the
// next two jobs' cp.async loads in flight while one is computed.  B's rows
// are reversed by index as they load.  Thread (lane l, chunk q) computes:
//   * the butterflies: the strides >= TPL (= 2C/R, threads a lane) in
//     registers on rows q + TPL·j, one shared-memory exchange to rows
//     R·q + j, the strides in [R, TPL) by warp shuffle, the rest in
//     registers (at C = 1024: 5 stages, the exchange, 1 shuffle, 5);
//   * the punch from its neighbours' edge rows (one small exchange), its
//     chunk's total, a segmented suffix scan of the totals (shuffles in the
//     warp, one exchange across warps), then its rows' suffix sums, stored
//     straight from registers (a warp stores 32/LT whole rows).
// The plane buffers are [row][lane] with row r at r ^ ((r >> 5) & (32/LT -
// 1)), so both the strided and the chunked reads hit 32 banks.
// Shared memory: 3 x 512·R words of plane buffers, 4 x 512 words of edges
// and scan totals (204,800 B at R = 32) — orset_floor.floor_tile_plan.
//
// Kernel 8, the segment walk (bucketed_floor_union at Wb <= 16): on the
// ring of segment_ring.cuh, the body of kernel 3.  A 256-thread CTA takes
// up to 256 adjacent lanes and walks the buckets in order, each bucket's
// four planes [plane][row][lane] in one of `stages` buffers (1 KB row
// requests).  Thread t holds lane t's 2·Wb rows of a plane in registers.
// The punch crosses bucket edges: row 0 takes the previous segment's last
// butterflied key, carried in a register; the last row needs the next
// segment's butterflied row 0, which by (b) is the next bucket's row 0
// after its own butterflies — so the thread finishes bucket b - 1 (its
// last row's term and its stores) once bucket b's butterflies are done,
// and holds Wb suffix sums and Wb suffix ORs in registers meanwhile.  nu
// stays in a register until the last bucket.  Stores are whole W-lane rows.
// Shared memory: stages x 4 x Wb x W words — orset_floor.bucketed_floor_plan.
//
// Each launcher checks the host's figure against its layout; past the card's
// opt-in limit cudaFuncSetAttribute refuses, and the wrapper raises.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_ring.cuh"
#include "tile_union.cuh"

namespace {

using tile_union::cp_async16;
using tile_union::cp_async4;
using tile_union::cp_async_commit;
using tile_union::cp_async_wait;

constexpr uint32_t kSentinel = 0x7FFFFFFFu;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int ilog2c(int x) { return x <= 1 ? 0 : 1 + ilog2c(x / 2); }

// bits 16-31 of disp's suffix OR, arithmetic: the low half of the values'
// suffix OR, sign-extended (fact (a))
__device__ __forceinline__ int32_t value_out(uint32_t v_or) {
  return static_cast<int32_t>(v_or << 16) >> 16;
}

template <bool kKeys>
__device__ __forceinline__ void bfly(uint32_t& a, uint32_t& b) {
  const uint32_t x = a, y = b;
  if constexpr (kKeys) {
    a = x + y;
    b = x - y;
  } else {
    a = x | y;
    b = x ^ y;
  }
}

// The butterfly stages of x[0..N) at register distances N/2, ..., 1 (row
// strides unit·N/2, ..., unit), widest first, those whose stride is <= hi.
template <bool kKeys, int N>
__device__ __forceinline__ void reg_stages(uint32_t* x, int unit, int hi) {
#pragma unroll
  for (int k = ilog2c(N) - 1; k >= 0; --k) {
    if ((unit << k) > hi) continue;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (!(j & (1 << k))) bfly<kKeys>(x[j], x[j + (1 << k)]);
    }
  }
}

__device__ __forceinline__ bool aligned16(const int32_t* a, const int32_t* b,
                                          const int32_t* c, const int32_t* d) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) & 15) == 0;
}

// ---- kernel 7: the tile body ----

constexpr int kTileThreads = 512;
constexpr int kRing = 3;          // plane buffers
constexpr int kMaxRows = 8192;    // rows of an operand: one lane a tile at R = 32

struct TileArgs {
  const int32_t* ka;  // inputs (c, lanes)
  const int32_t* va;
  const int32_t* kb;
  const int32_t* vb;
  int32_t* ko;        // outputs (c / seg * out_seg, lanes) and (lanes)
  int32_t* vo;
  int32_t* nu;
  int c;        // rows of each input plane, a power of two
  int lanes;
  int seg;      // rows an operand puts in a segment, a power of two <= c
  int out_seg;  // output rows of a segment, 0 .. 2 seg
  int lt;       // lanes a tile: 512 x R / 2c
};

__host__ __device__ inline int tile_rows(int c) { return 2 * c < 32 ? 2 * c : 32; }

__host__ __device__ inline size_t tile_smem_bytes(int c) {
  return sizeof(uint32_t) * ((size_t)kRing * kTileThreads * tile_rows(c) + 4 * kTileThreads);
}

// what every thread derives from the launch
struct TileShape {
  int n;          // rows of a lane, 2c
  int lt_shift;
  int tpl;        // threads a lane
  int tpl_shift;
  int seg_shift;
  int mask;       // the row swizzle: r ^ ((r >> 5) & mask)
  int wq;         // chunks of one lane in a warp
  int wq_shift;
  int g;          // chunks a segment (1: a chunk holds whole segments)
};

__device__ __forceinline__ int swz(int r, int mask) { return r ^ ((r >> 5) & mask); }

// Request one plane (keys when `values` is 0) of both operands for tile
// `tile` into `buf`: merged row m of lane l at word swz(m)·LT + l; 16 B a
// thread when `vec`, else 4 B; lanes past L read nothing.
__device__ __forceinline__ void load_plane(const TileArgs& p, const TileShape& s,
                                           uint32_t* buf, long long tile, int values,
                                           bool vec) {
  const int c = p.c, c_shift = __ffs(c) - 1;
  const long long lanes = p.lanes, l0 = tile << s.lt_shift;
  const int q_shift = vec ? s.lt_shift - 2 : s.lt_shift;  // chunks a row, log2
  const int chunk = vec ? 4 : 1;                          // lanes a chunk
  const int32_t* src_a = values ? p.va : p.ka;
  const int32_t* src_b = values ? p.vb : p.kb;
  const int items = (2 * c) << q_shift;
  for (int w = threadIdx.x; w < items; w += kTileThreads) {
    const int h = w & ((1 << q_shift) - 1), rest = w >> q_shift;
    const int side = rest >> c_shift, r = rest & (c - 1);
    const int i = r & (p.seg - 1);
    // A's row i of segment sg to merged row 2·seg·sg + i, B's to
    // 2·seg·sg + 2·seg - 1 - i
    const int m = ((r >> s.seg_shift) << (s.seg_shift + 1)) + (side ? 2 * p.seg - 1 - i : i);
    const long long lane = l0 + h * chunk;
    const long long left = lanes - lane;
    const int valid = left <= 0 ? 0 : (left >= chunk ? chunk : (int)left);
    uint32_t* dst = buf + (size_t)swz(m, s.mask) * p.lt + h * chunk;
    const int32_t* base = side ? src_b : src_a;
    const int32_t* src = valid ? base + (size_t)r * lanes + lane : base;
    if (vec) cp_async16(dst, src, 4 * valid);
    else cp_async4(dst, src, 4 * valid);
  }
}

// One plane of one tile (keys when kKeys), from its landed buffer to its
// output rows; calls `issue_next()` (every thread) once the buffer is free.
// A segment (2·seg rows) holds whole chunks (2·seg >= R: the launcher
// checks), so a chunk's rows lie in one segment and only a chunk that ends
// its segment starts its suffix scan from zero.
template <int R, bool kKeys, class Next>
__device__ __forceinline__ void floor_plane(const TileArgs& p, const TileShape& s,
                                            uint32_t* buf, uint32_t* scratch, long long tile,
                                            Next issue_next) {
  constexpr int kLogR = ilog2c(R);
  const int t = threadIdx.x, lt = p.lt;
  const int l = t & (lt - 1), q = t >> s.lt_shift;
  uint32_t x[R];

  // 1. butterflies at strides >= TPL on rows q + TPL·j, in registers.  The
  // swizzle of row q + TPL·j repeats every two j (TPL·2 is a multiple of
  // 32·(mask + 1)) and TPL·LT = 512, so row j sits 512·(j & ~1) words past
  // row j & 1: two base pointers, the rest immediate offsets.
  uint32_t* c0 = buf + swz(q, s.mask) * lt + l;
  uint32_t* c1 = buf + swz(q + s.tpl, s.mask) * lt + l;
#pragma unroll
  for (int j = 0; j < R; ++j) x[j] = ((j & 1) ? c1 : c0)[kTileThreads * (j & ~1)];
  reg_stages<kKeys, R>(x, s.tpl, p.seg);
#pragma unroll
  for (int j = 0; j < R; ++j) ((j & 1) ? c1 : c0)[kTileThreads * (j & ~1)] = x[j];
  __syncthreads();
  // 2. the chunk's rows R·q + j, at word ((R·q + (j ^ m))·LT + l, m = q &
  // mask: the base's bits and j·LT's do not overlap, so an XOR places row
  // j.  The strides in [R, TPL) by shuffle with the partner chunk, then
  // those below, in registers — widest first.
  const int base2 = ((q << kLogR) + (q & s.mask)) * lt + l;
#pragma unroll
  for (int j = 0; j < R; ++j) x[j] = buf[base2 ^ (j << s.lt_shift)];
  for (int st = s.tpl >> 1; st >= R; st >>= 1) {
    if (st > p.seg) continue;
    const int d = st >> kLogR;
    const bool upper = q & d;
    const int lane_mask = d << s.lt_shift;
    // keys: lower a + b, upper a - b (= y + x·-1); values: lower a | b,
    // upper a ^ b (= (a | b) & ~(a & b))
    const uint32_t sign = upper ? 0xFFFFFFFFu : 1u;
    const uint32_t both = upper ? 0xFFFFFFFFu : 0u;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const uint32_t y = __shfl_xor_sync(kFull, x[j], lane_mask);
      if constexpr (kKeys) x[j] = y + x[j] * sign;
      else x[j] = (x[j] | y) & ~(x[j] & y & both);
    }
  }
  reg_stages<kKeys, R>(x, 1, min(p.seg, s.tpl >> 1));

  // 3. the punch, over the whole lane, from the neighbouring chunks' edges,
  // and the chunk's totals (sum or OR of its rows, and its odd keys)
  uint32_t* first = scratch;
  uint32_t* last = scratch + kTileThreads;
  uint32_t* gsum = scratch + 2 * kTileThreads;
  uint32_t* gcnt = scratch + 3 * kTileThreads;
  first[t] = x[0];
  last[t] = x[R - 1];
  __syncthreads();  // every read of the buffer is done
  issue_next();
  const bool has_next = q + 1 < s.tpl;
  const uint32_t after = has_next ? first[t + lt] : 0u;
  uint32_t a = 0, b = 0;
  if constexpr (kKeys) {
    // k1[i] = k[i] + k[i-1] (k[-1] = SENTINEL); k3[i] = k1[i] ^ k1[i+1]
    // (k1[n] = 0)
    uint32_t before = q ? last[t - lt] : kSentinel;
    const uint32_t k1_after = has_next ? after + x[R - 1] : 0u;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const uint32_t k = x[j];
      x[j] = k + before;
      before = k;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      x[j] ^= j + 1 < R ? x[j + 1] : k1_after;
      a += x[j];
      b += x[j] & 1u;
    }
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      x[j] |= j + 1 < R ? x[j + 1] : after;
      a |= x[j];
    }
  }

  // 4. what the later chunks of this chunk's segment carry: the totals'
  // exclusive suffix, in the warp by shuffles, across warp groups through
  // shared memory
  uint32_t carry = 0, carry_odd = 0;
  if (s.g > 1) {
    const int gw = s.g < s.wq ? s.g : s.wq;  // chunks of a segment in a warp
    for (int d = 1; d < gw; d <<= 1) {
      const uint32_t ya = __shfl_down_sync(kFull, a, d << s.lt_shift);
      const uint32_t yb = __shfl_down_sync(kFull, b, d << s.lt_shift);
      if ((q & (gw - 1)) + d < gw) {
        a = kKeys ? a + ya : a | ya;
        b += yb;
      }
    }
    if (gw > 1) {
      const uint32_t na = __shfl_down_sync(kFull, a, lt);
      const uint32_t nb = __shfl_down_sync(kFull, b, lt);
      const bool end = (q & (gw - 1)) == gw - 1;
      carry = end ? 0u : na;
      carry_odd = end ? 0u : nb;
    }
    if (s.g > s.wq) {  // the segment spans warp groups
      const int grp = q >> s.wq_shift;
      if ((q & (s.wq - 1)) == 0) {
        gsum[grp * lt + l] = a;
        gcnt[grp * lt + l] = b;
      }
      __syncthreads();
      const int end_grp = grp | ((s.g >> s.wq_shift) - 1);
      for (int k = grp + 1; k <= end_grp; ++k) {
        carry = kKeys ? carry + gsum[k * lt + l] : carry | gsum[k * lt + l];
        carry_odd += gcnt[k * lt + l];
      }
    }
  }

  // 5. the suffix scan over the chunk, backwards; the chunk's rows among
  // the first out_seg of their segment are stored, and the odd count at
  // the last segment's first row is nu
  const long long lanes = p.lanes, lane = (tile << s.lt_shift) + l;
  const bool live = lane < lanes;
  const int seg2_shift = s.seg_shift + 1;
  const int i0 = q << kLogR, r0 = i0 & ((2 << s.seg_shift) - 1);
  const int keep = p.out_seg - r0;  // rows j < keep are stored
  int32_t* dst = (kKeys ? p.ko : p.vo) +
                 ((size_t)(i0 >> seg2_shift) * p.out_seg + r0) * lanes + lane;
  uint32_t acc = carry, odd = carry_odd;
#pragma unroll
  for (int j = R - 1; j >= 0; --j) {
    if constexpr (kKeys) {
      acc += x[j];
      odd += x[j] & 1u;
    } else {
      acc |= x[j];
    }
    if (live && j < keep) dst[(size_t)j * lanes] = kKeys ? (int32_t)acc : value_out(acc);
  }
  if (kKeys && live && i0 == s.n - (2 << s.seg_shift)) p.nu[lane] = (int32_t)odd;
}

template <int R>
__global__ void __launch_bounds__(kTileThreads, 1) floor_tile_kernel(TileArgs p) {
  extern __shared__ uint32_t smem_u[];
  constexpr int kPlane = kTileThreads * R;  // words of a plane buffer: LT lanes x 2C rows
  TileShape s;
  s.n = 2 * p.c;
  s.lt_shift = __ffs(p.lt) - 1;
  s.tpl = kTileThreads >> s.lt_shift;
  s.tpl_shift = __ffs(s.tpl) - 1;
  s.seg_shift = __ffs(p.seg) - 1;
  s.mask = p.lt >= 32 ? 0 : (32 >> s.lt_shift) - 1;
  s.wq = p.lt >= 32 ? 1 : 32 >> s.lt_shift;
  s.wq_shift = __ffs(s.wq) - 1;
  s.g = 2 * p.seg > R ? 2 * p.seg / R : 1;
  uint32_t* scratch = smem_u + kRing * kPlane;

  const long long n_tiles = ((long long)p.lanes + p.lt - 1) >> s.lt_shift;
  const long long my_tiles =
      (long long)blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long jobs = 2 * my_tiles;  // keys, then values, of each tile
  const bool vec = p.lt % 4 == 0 && p.lanes % 4 == 0 && aligned16(p.ka, p.va, p.kb, p.vb);
  auto load = [&](long long j) {
    if (j < jobs) {
      load_plane(p, s, smem_u + (j % kRing) * kPlane, blockIdx.x + (j >> 1) * gridDim.x,
                 (int)(j & 1), vec);
    }
    cp_async_commit();
  };
  for (int j = 0; j < kRing; ++j) load(j);
  for (long long j = 0; j < jobs; ++j) {
    cp_async_wait<kRing - 1>();
    __syncthreads();  // job j has landed; the last job's scratch reads are done
    uint32_t* buf = smem_u + (j % kRing) * kPlane;
    const long long tile = blockIdx.x + (j >> 1) * gridDim.x;
    auto next = [&] { load(j + kRing); };
    if (j & 1) floor_plane<R, false>(p, s, buf, scratch, tile, next);
    else floor_plane<R, true>(p, s, buf, scratch, tile, next);
  }
  cp_async_wait<0>();
}

int log2_exact(int x) {
  int s = 0;
  while ((1 << s) < x) ++s;
  return (1 << s) == x ? s : -1;
}

cudaError_t launch_tile(const TileArgs& p, int smem, cudaStream_t stream) {
  const int c_shift = log2_exact(p.c), seg_shift = log2_exact(p.seg);
  const int rows = c_shift < 0 ? 0 : tile_rows(p.c);
  if (c_shift < 0 || p.c > kMaxRows || seg_shift < 0 || p.seg > p.c || 2 * p.seg < rows ||
      p.lanes <= 0 ||
      p.out_seg < 0 || p.out_seg > 2 * p.seg || log2_exact(p.lt) < 0 ||
      (long long)p.lt * 2 * p.c != (long long)kTileThreads * rows || smem < 0 ||
      (size_t)smem < tile_smem_bytes(p.c)) {
    return cudaErrorInvalidValue;
  }
  void (*kernel)(TileArgs);
  switch (rows) {
    case 2: kernel = floor_tile_kernel<2>; break;
    case 4: kernel = floor_tile_kernel<4>; break;
    case 8: kernel = floor_tile_kernel<8>; break;
    case 16: kernel = floor_tile_kernel<16>; break;
    default: kernel = floor_tile_kernel<32>; break;
  }
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTileThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = ((long long)p.lanes + p.lt - 1) / p.lt;
  const long long grid = tiles < (long long)per_sm * sms ? tiles : (long long)per_sm * sms;
  kernel<<<(unsigned)grid, kTileThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---- kernel 8: the segment walk ----

constexpr int kWalkMaxWb = 16;  // 2·Wb rows of a plane in registers

struct WalkArgs {
  const int32_t* ka;  // inputs (c, lanes)
  const int32_t* va;
  const int32_t* kb;
  const int32_t* vb;
  int32_t* ko;        // outputs (c, lanes) and (lanes)
  int32_t* vo;
  int32_t* nu;
  int c;        // rows of each input plane: B * Wb
  int lanes;
  int wb;       // rows of a bucket, a power of two <= kWalkMaxWb
  int stages;   // bucket buffers, 1 .. 4
  static constexpr int width = segment_ring::kMaxWidth;  // lanes a CTA
};

size_t walk_smem_bytes(const WalkArgs& p) {
  return sizeof(int32_t) * (size_t)p.stages * 4 * p.wb * p.width;
}

template <int WB>
__global__ void __launch_bounds__(segment_ring::kThreads) floor_walk_kernel(WalkArgs p) {
  constexpr int N = 2 * WB;  // rows of a segment
  extern __shared__ int32_t smem[];
  const int t = threadIdx.x, w = p.width;
  const int wb_shift = ilog2c(WB), w_shift = __ffs(w) - 1;
  const int n_buckets = p.c >> wb_shift;
  const long long lanes = p.lanes, lane0 = (long long)blockIdx.x * w, lane = lane0 + t;
  const size_t stage_words = (size_t)4 * WB * w;
  const bool vec_in = w % 4 == 0 && p.lanes % 4 == 0 && aligned16(p.ka, p.va, p.kb, p.vb);
  const bool live = t < w && lane < lanes;

  for (int s = 0; s < p.stages; ++s) {
    if (s < n_buckets) {
      segment_ring::load_bucket(p, s, smem + s * stage_words, lane0, vec_in, wb_shift, w_shift);
    }
    cp_async_commit();
  }
  // what bucket b - 1 leaves for bucket b to finish: its first Wb rows'
  // key sums and value ORs over rows .. 2·Wb - 2, k1 at its last row, and
  // its last butterflied key and value (the key: SENTINEL before bucket 0,
  // the punch's fill)
  uint32_t ks[WB], vs[WB];
  uint32_t k_last = kSentinel, k1_last = 0, v_last = 0, odd = 0;
  auto finish = [&](int bb, uint32_t k1_next, uint32_t v_next) {
    const uint32_t k3_last = k1_last ^ k1_next, v2_last = v_last | v_next;
#pragma unroll
    for (int i = 0; i < WB; ++i) {
      const size_t at = ((size_t)bb * WB + i) * lanes + lane;
      p.ko[at] = (int32_t)(ks[i] + k3_last);
      p.vo[at] = value_out(vs[i] | v2_last);
    }
    return k3_last;
  };
  for (int b = 0; b < n_buckets; ++b) {
    const int slot = b % p.stages;
    segment_ring::cp_async_wait_dyn(p.stages - 1);
    __syncthreads();  // bucket b has landed
    if (live) {
      const int32_t* col = smem + slot * stage_words + t;
      uint32_t x[N], y[N];
      // keys A ++ B reversed, and values the same, butterflied
#pragma unroll
      for (int i = 0; i < WB; ++i) {
        x[i] = col[i * w];
        x[WB + i] = col[(3 * WB - 1 - i) * w];
        y[i] = col[(WB + i) * w];
        y[WB + i] = col[(4 * WB - 1 - i) * w];
      }
      reg_stages<true, N>(x, 1, WB);
      reg_stages<false, N>(y, 1, WB);
      // bucket b - 1's last row: k1 there ^ (this segment's row 0 + its last key)
      if (b > 0) finish(b - 1, x[0] + k_last, y[0]);
      // the punch inside this segment, rows 0 .. 2·Wb - 2 complete
      uint32_t before = k_last;
      k_last = x[N - 1];
      v_last = y[N - 1];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const uint32_t k = x[j];
        x[j] = k + before;
        before = k;
      }
      k1_last = x[N - 1];
#pragma unroll
      for (int j = 0; j + 1 < N; ++j) {
        x[j] ^= x[j + 1];
        y[j] |= y[j + 1];
      }
      uint32_t acc = 0, bits = 0;
      odd = 0;
#pragma unroll
      for (int j = N - 2; j >= 0; --j) {
        acc += x[j];
        bits |= y[j];
        odd += x[j] & 1u;
        if (j < WB) {
          ks[j] = acc;
          vs[j] = bits;
        }
      }
    }
    __syncthreads();  // every read of this slot is done
    if (b + p.stages < n_buckets) {
      segment_ring::load_bucket(p, b + p.stages, smem + slot * stage_words, lane0, vec_in,
                                wb_shift, w_shift);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  if (live) {
    // the last segment: k1 past the lane's end is 0, and so is the value
    const uint32_t k3_last = finish(n_buckets - 1, 0u, 0u);
    p.nu[lane] = (int32_t)(odd + (k3_last & 1u));
  }
}

cudaError_t launch_walk(const WalkArgs& p, int smem, cudaStream_t stream) {
  if (log2_exact(p.wb) < 0 || p.wb > kWalkMaxWb || p.c < p.wb || p.c % p.wb != 0 ||
      p.lanes <= 0 || p.stages < 1 ||
      p.stages > segment_ring::kMaxStages || smem < 0 || (size_t)smem < walk_smem_bytes(p)) {
    return cudaErrorInvalidValue;
  }
  void (*kernel)(WalkArgs);
  switch (p.wb) {
    case 1: kernel = floor_walk_kernel<1>; break;
    case 2: kernel = floor_walk_kernel<2>; break;
    case 4: kernel = floor_walk_kernel<4>; break;
    case 8: kernel = floor_walk_kernel<8>; break;
    default: kernel = floor_walk_kernel<16>; break;
  }
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = ((long long)p.lanes + p.width - 1) / p.width;
  kernel<<<(unsigned)blocks, segment_ring::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on `stream` with the host's plan and `smem` bytes of
// shared memory a CTA (checked against the body's layout) and returns a
// cudaError_t.  Planes are contiguous (c, lanes) int32, B as the caller
// holds it (not flipped).

// Kernel 7, the tile body: segments of `seg` rows an operand (c for
// floor_union), the first `out_seg` rows of each kept, into (c / seg *
// out_seg, lanes) planes and nu (lanes); `lane_tile` lanes a tile
// (orset_floor.floor_tile_plan).
int floor_union(const void* ka, const void* va, const void* kb, const void* vb, void* ko,
                void* vo, void* nu, int c, int lanes, int seg, int out_seg, int lane_tile,
                int smem, void* stream) {
  TileArgs p = {};
  p.ka = static_cast<const int32_t*>(ka);
  p.va = static_cast<const int32_t*>(va);
  p.kb = static_cast<const int32_t*>(kb);
  p.vb = static_cast<const int32_t*>(vb);
  p.ko = static_cast<int32_t*>(ko);
  p.vo = static_cast<int32_t*>(vo);
  p.nu = static_cast<int32_t*>(nu);
  p.c = c;
  p.lanes = lanes;
  p.seg = seg;
  p.out_seg = out_seg;
  p.lt = lane_tile;
  return launch_tile(p, smem, static_cast<cudaStream_t>(stream));
}

// Kernel 8, the segment walk: c / wb buckets of wb rows, the first wb rows
// of each segment kept, into (c, lanes) planes and nu (lanes); 256 lanes a
// CTA, `stages` bucket buffers (orset_floor.bucketed_floor_plan).
int bucketed_floor_walk(const void* ka, const void* va, const void* kb, const void* vb,
                        void* ko, void* vo, void* nu, int c, int lanes, int wb, int stages,
                        int smem, void* stream) {
  WalkArgs p = {};
  p.ka = static_cast<const int32_t*>(ka);
  p.va = static_cast<const int32_t*>(va);
  p.kb = static_cast<const int32_t*>(kb);
  p.vb = static_cast<const int32_t*>(vb);
  p.ko = static_cast<int32_t*>(ko);
  p.vo = static_cast<int32_t*>(vo);
  p.nu = static_cast<int32_t*>(nu);
  p.c = c;
  p.lanes = lanes;
  p.wb = wb;
  p.stages = stages;
  return launch_walk(p, smem, static_cast<cudaStream_t>(stream));
}

const char* set_floor_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
