// The lane-tile union: one body for three kernels, the single-key OR-Set union
// (set_union.cu, `set_union`) and the lexN union at narrow keys
// (lexn_union.cu, the OpLog's (hi, lo) split), and, in its keep-all mode, the
// single-key merge (set_union.cu, `set_merge`).
//
// Contract (per lane j of (C, L) int32 planes, keys first, then values):
// both operands' rows ascend lexicographically over the n_keys key words
// with a SENTINEL tail (a row is padding when key word 0 is SENTINEL).  The
// output is the merge of A's and B's 2C rows, A's copy first among equal
// keys, with every row equal to the row before it (and not padding) punched:
// its value planes OR into that row (OR-combine-then-keep-first), then the
// kept rows ascend from row 0, the first `out_size` of them written and the
// rest SENTINEL / 0; n_unique[j] is the kept count before truncation.  This
// is the plain twins' rule row for row, so the result is bit-equal to them.
// Keep-all mode (a compile-time parameter, tile_merge_kernel) keeps every
// merged row, padding included: no row is punched, no value ORed, out_size
// is 2C and no n_unique is written — a stable merge, A's rows first among
// equal keys, each row with its own values.
//
// What bounds it on an H100: bytes in principle — it reads every plane once
// and writes the output once, against ~2C compares a lane — and in fact
// the number of row requests: a lane's column is strided by L, so each row
// of a tile is its own request, and at L = 2^20 (rows 4 MB apart) an SM
// serves them at a fixed rate (~3 ns each), whatever their size up to
// 64 B (PERF.md, the kernel table).  So the design is about the memory
// system:
//   * a tile is LT adjacent lanes (8 where it fits: each row of a plane is
//     then one whole 32 B sector, half the requests of 4 lanes).  The key
//     words of both operands are staged in shared memory, row-major as
//     they lie in device memory, and where it fits one buffer of the value
//     planes too (else the move gathers them from device memory, prefetched
//     into L2);
//   * persistent CTAs walk the tiles (tile, tile + grid, ...: neighbouring
//     CTAs take neighbouring tiles at the same time) with a ring of
//     `stages` key buffers, all copies by cp.async (16 B a thread where the
//     tile, L and the planes allow, else 4 B; lanes past L read nothing and
//     fill zeros): with two, the next tile's keys are in flight while this
//     tile ranks and moves, and the values of a tile load while it ranks;
//   * ranking by merge path: thread (lane l, chunk q) takes 32 consecutive
//     merged rows of lane l, finds its co-rank by one binary search, walks
//     its rows with the heads in registers (one shared load a row) and
//     records each row's side, kept flag and "the next row ORs in" flag as
//     bits; a warp holds 4 chunks of each of 8 lanes;
//   * a segmented scan over each lane's chunks gives each kept row its output
//     row; replaying the bits writes a map of output row -> source row (A or
//     B, 16 bits) and the row that ORs in (16 bits);
//   * the move: a warp takes 32/LT output rows x LT lanes, reads the map,
//     the key words and staged values from shared memory, 8 rows of a
//     thread in flight a plane, and stores whole rows of the tile.
// In keep-all mode an output row is its merged row, so the walk writes the
// map directly (no bits, no scan) and the map holds only the 16-bit source:
// half the map's bytes, which leaves room at C = 1024 for the second key
// stage.
// Shared memory (words): stages x 2 x n_keys x C x LT keys, 2 x n_vals x C
// x LT staged values, out_size x LT map (half words in keep-all mode),
// (warps + 1) x LT scan sums and totals — the host's
// hopper_union.tile_union_smem_bytes; the launcher checks the figure it is
// given against this layout.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_union {

constexpr int32_t kSentinel = 0x7FFFFFFF;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPlanes = 32;   // key + value planes a side
constexpr int kMaxKeys = 4;      // key words the tile body takes
constexpr int kMaxRows = 16384;  // rows of an operand: a source fits 15 bits
constexpr int kRankRows = 32;    // merged rows a thread ranks after its search
constexpr int kMoveRows = 8;     // output rows a thread moves together
constexpr uint32_t kNone = 0xFFFFu;

struct Args {
  const int32_t* a[kMaxPlanes];  // keys, then values
  const int32_t* b[kMaxPlanes];
  int32_t* out[kMaxPlanes];
  int32_t* n_unique;
  int c;         // rows of each input plane
  int lanes;
  int out_size;  // rows of each output plane
  int n_keys;
  int n_vals;
  int lt;          // lanes a tile: 1, 2, 4 or 8
  int stages;      // key buffers: 1 or 2
  int stage_vals;  // 1: one buffer of the value planes; 0: gather them
};

// `keep_all`: a map entry is the 16-bit source alone, not source and OR
// partner
__host__ __device__ inline size_t smem_bytes(const Args& p, bool keep_all = false) {
  return sizeof(int32_t) *
             ((size_t)p.stages * 2 * p.n_keys * p.c * p.lt +
              (size_t)p.stage_vals * 2 * p.n_vals * p.c * p.lt +
              (size_t)(kWarps + 1) * p.lt) +
         (keep_all ? sizeof(uint16_t) : sizeof(uint32_t)) * p.out_size * p.lt;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Request planes [first, first + count) of both operands for tile `tile`
// into `buf`, laid out [side][plane][row][lane of the tile]: 16 B a thread
// (LT/4 of them a row) when `vec`, else 4 B.  C and LT are powers of two.
__device__ __forceinline__ void load_planes(const Args& p, int first, int count,
                                            int32_t* buf, long long tile, bool vec,
                                            int c_shift, int lt_shift) {
  const int lt = 1 << lt_shift;
  const long long lanes = p.lanes, l0 = tile << lt_shift;
  const int q_shift = vec ? lt_shift - 2 : lt_shift;  // chunks a row, log2
  const int width = vec ? 4 : 1;                      // lanes a chunk
  const int items = (2 * count) << (c_shift + q_shift);
  for (int w = threadIdx.x; w < items; w += kThreads) {
    const int h = w & ((1 << q_shift) - 1), rest = w >> q_shift;
    const int row = rest & ((1 << c_shift) - 1), sk = rest >> c_shift;
    const int side = sk >= count, k = first + sk - side * count;
    const int32_t* plane = side ? p.b[k] : p.a[k];
    const long long lane = l0 + h * width;
    const long long left = lanes - lane;
    const int valid = left <= 0 ? 0 : (left >= width ? width : (int)left);
    int32_t* dst = buf + (((size_t)sk << c_shift) + row) * lt + h * width;
    const int32_t* src = valid ? plane + (size_t)row * lanes + lane : plane;
    if (vec) cp_async16(dst, src, 4 * valid);
    else cp_async4(dst, src, 4 * valid);
  }
}

// Prefetch planes [first, first + count) of both operands for tile `tile`
// into L2, a row at a time (the values, when they are gathered rather than
// staged).
__device__ __forceinline__ void prefetch_planes(const Args& p, int first, int count,
                                                long long tile, int c_shift, int lt_shift) {
  const long long lanes = p.lanes, l0 = tile << lt_shift;
  const int rows = (2 * count) << c_shift;
  for (int w = threadIdx.x; w < rows; w += kThreads) {
    const int row = w & ((1 << c_shift) - 1), sk = w >> c_shift;
    const int side = sk >= count, k = first + sk - side * count;
    prefetch_l2((side ? p.b[k] : p.a[k]) + (size_t)row * lanes + l0);
  }
}

// x < y over nk words
template <int kKeys>
__device__ __forceinline__ bool lex_less(const int32_t* x, const int32_t* y, int nk) {
#pragma unroll
  for (int k = 0; k < kKeys; ++k) {
    if (k < nk && x[k] != y[k]) return x[k] < y[k];
  }
  return false;
}

template <int kKeys>
__device__ __forceinline__ bool lex_equal(const int32_t* x, const int32_t* y, int nk) {
  bool eq = true;
#pragma unroll
  for (int k = 0; k < kKeys; ++k) eq = eq && (k >= nk || x[k] == y[k]);
  return eq;
}

// the row `row` of one side's staged keys (`col` = the side's word 0 at
// row 0, lane l) into registers
template <int kKeys>
__device__ __forceinline__ void read_row(int32_t* x, const int32_t* col, int row,
                                         int nk, int word_stride, int lt) {
#pragma unroll
  for (int k = 0; k < kKeys; ++k) {
    if (k < nk) x[k] = col[k * word_stride + row * lt];
  }
}

// Exclusive scan of `cnt` over the threads of lane t % lt, in thread
// order; *total gets the lane's sum.  Every thread of the CTA calls it.
__device__ __forceinline__ int lane_scan(int cnt, int* warp_sums, int lt, int* total) {
  const int t = threadIdx.x, wid = t >> 5, wl = t & 31, l = t % lt;
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    if (o < lt) continue;
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (wl >= o) incl += y;
  }
  if (wl >= 32 - lt) warp_sums[wid * lt + l] = incl;
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int x = warp_sums[w * lt + l];
    if (w < wid) before += x;
    sum += x;
  }
  __syncthreads();  // warp_sums is reused by the next call
  *total = sum;
  return incl - cnt + before;
}

// The keep-all rank: each thread walks its 32 merged rows and writes each
// row's 16-bit source straight into the map (output row = merged row).
template <int kKeys>
__device__ __forceinline__ int rank_keep_all(const Args& p, const int32_t* buf,
                                             uint16_t* map) {
  constexpr int K = kKeys ? kKeys : kMaxKeys;
  const int nk = kKeys ? kKeys : p.n_keys;
  const int lt = p.lt, c = p.c, n = 2 * c;
  const int t = threadIdx.x, l = t % lt, q = t / lt, tpl = kThreads / lt;
  const int ws = c * lt;
  const int32_t* col_a = buf + l;
  const int32_t* col_b = buf + (size_t)nk * ws + l;
  for (int base = 0; base < n; base += kRankRows * tpl) {
    const int d0 = min(n, base + q * kRankRows), d1 = min(n, d0 + kRankRows);
    if (d0 >= d1) continue;
    int lo = max(0, d0 - c), hi = min(d0, c);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      int32_t x[K], y[K];
      read_row<K>(x, col_a, mid, nk, ws, lt);
      read_row<K>(y, col_b, d0 - 1 - mid, nk, ws, lt);
      if (!lex_less<K>(y, x, nk)) lo = mid + 1; else hi = mid;
    }
    int ia = lo, ib = d0 - lo;
    int32_t ha[K], hb[K];
    if (ia < c) read_row<K>(ha, col_a, ia, nk, ws, lt);
    if (ib < c) read_row<K>(hb, col_b, ib, nk, ws, lt);
    for (int d = d0; d < d1; ++d) {
      const bool ta = ia < c && (ib >= c || !lex_less<K>(hb, ha, nk));
      map[(size_t)d * lt + l] = (uint16_t)(ta ? ia : (0x8000 | ib));
      if (ta) {
        if (++ia < c) read_row<K>(ha, col_a, ia, nk, ws, lt);
      } else {
        if (++ib < c) read_row<K>(hb, col_b, ib, nk, ws, lt);
      }
    }
  }
  return n;
}

// Rank one tile's lanes (keys in `buf`) into `map`; returns lane t % lt's
// kept count.  The source of a merged row: bit 15 = B, bits 0-14 = row.
template <int kKeys>
__device__ __forceinline__ int rank_tile(const Args& p, const int32_t* buf,
                                         uint32_t* map, int* warp_sums) {
  constexpr int K = kKeys ? kKeys : kMaxKeys;
  const int nk = kKeys ? kKeys : p.n_keys;
  const int lt = p.lt, c = p.c, n = 2 * c, out = p.out_size;
  const int t = threadIdx.x, l = t % lt, q = t / lt, tpl = kThreads / lt;
  const int ws = c * lt;  // stride of a key word
  const int32_t* col_a = buf + l;
  const int32_t* col_b = buf + (size_t)nk * ws + l;
  int running = 0;
  for (int base = 0; base < n; base += kRankRows * tpl) {
    const int d0 = min(n, base + q * kRankRows), d1 = min(n, d0 + kRankRows);
    uint32_t take_b = 0, kept = 0, or_next = 0;
    bool last_b = false;  // the walk took B's row at d1
    int cnt = 0, ia0 = 0, ib0 = 0;
    if (d0 < d1) {
      // co-rank: A's rows among the first d0 merged (A first on ties)
      int lo = max(0, d0 - c), hi = min(d0, c);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        int32_t x[K], y[K];
        read_row<K>(x, col_a, mid, nk, ws, lt);
        read_row<K>(y, col_b, d0 - 1 - mid, nk, ws, lt);
        if (!lex_less<K>(y, x, nk)) lo = mid + 1; else hi = mid;
      }
      ia0 = lo;
      ib0 = d0 - lo;
      int ia = ia0, ib = ib0;
      int32_t ha[K], hb[K], hp[K];
      if (ia < c) read_row<K>(ha, col_a, ia, nk, ws, lt);
      if (ib < c) read_row<K>(hb, col_b, ib, nk, ws, lt);
      // the merged row before d0: the later of A[ia-1] and B[ib-1]
      bool has_prev = d0 > 0;
      if (has_prev) {
        int32_t y[K];
        if (ia == 0) {
          read_row<K>(hp, col_b, ib - 1, nk, ws, lt);
        } else if (ib == 0) {
          read_row<K>(hp, col_a, ia - 1, nk, ws, lt);
        } else {
          read_row<K>(hp, col_a, ia - 1, nk, ws, lt);
          read_row<K>(y, col_b, ib - 1, nk, ws, lt);
          if (!lex_less<K>(y, hp, nk)) {
#pragma unroll
            for (int k = 0; k < K; ++k) hp[k] = y[k];
          }
        }
      }
      bool prev_kept = false;
      // rows d0 .. d1-1, then row d1 (when there is one) for the last
      // row's "next row ORs in" flag
      const int last = min(n, d1 + 1);
      for (int d = d0; d < last; ++d) {
        const bool ta = ia < c && (ib >= c || !lex_less<K>(hb, ha, nk));
        int32_t cur[K];
#pragma unroll
        for (int k = 0; k < K; ++k) cur[k] = ta ? ha[k] : hb[k];
        const bool pad = cur[0] == kSentinel;
        const bool dup = !pad && has_prev && lex_equal<K>(cur, hp, nk);
        const int bit = d - d0;
        if (dup && prev_kept) or_next |= 1u << (bit - 1);
        if (d == d1) {
          last_b = !ta;
          break;
        }
        prev_kept = !pad && !dup;
        if (prev_kept) {
          kept |= 1u << bit;
          ++cnt;
        }
        if (!ta) take_b |= 1u << bit;
#pragma unroll
        for (int k = 0; k < K; ++k) hp[k] = cur[k];
        has_prev = true;
        if (ta) {
          if (++ia < c) read_row<K>(ha, col_a, ia, nk, ws, lt);
        } else {
          if (++ib < c) read_row<K>(hb, col_b, ib, nk, ws, lt);
        }
      }
    }
    int round_total;
    int o = running + lane_scan(cnt, warp_sums, lt, &round_total);
    running += round_total;
    // replay the bits: each kept row's source and the row that ORs in
    int ia = ia0, ib = ib0;
    for (int bit = 0; bit < d1 - d0 && o < out; ++bit) {
      const bool b_side = (take_b >> bit) & 1u;
      const uint32_t src = b_side ? (0x8000u | ib) : (uint32_t)ia;
      if (b_side) ++ib; else ++ia;
      if (!((kept >> bit) & 1u)) continue;
      uint32_t next = kNone;
      if ((or_next >> bit) & 1u) {
        // the next merged row: the other side's head, or (past this
        // thread's rows) whichever side the walk took at row d1
        const bool nb = bit + 1 < d1 - d0 ? ((take_b >> (bit + 1)) & 1u) : last_b;
        next = nb ? (0x8000u | ib) : (uint32_t)ia;
      }
      map[(size_t)o * lt + l] = src | (next << 16);
      ++o;
    }
  }
  return running;
}

// Move output rows o_first, o_first + rp, ... (< o_end) of lane `l` of the
// tile (`lane` in the planes): its keys from the staged keys, its values
// from the staged values (`vals` non-null) or from device memory,
// kMoveRows rows in flight together a plane.  Neighbouring threads take
// neighbouring lanes, so a warp's stores are whole rows of the tile.  In
// keep-all mode `map` holds half words (a source, no OR partner) and every
// output row is filled.
template <int kKeys, bool kKeepAll>
__device__ __forceinline__ void move_rows(const Args& p, const int32_t* keys,
                                          const int32_t* vals, const void* map_words,
                                          const int* totals, int l, int lt, long long lane,
                                          int o_first, int o_end, int rp) {
  const int nk = kKeys ? kKeys : p.n_keys;
  const int nv = p.n_vals;
  if (lane >= p.lanes) return;
  const long long lanes = p.lanes;
  const int total = totals[l];
  const uint32_t* map = static_cast<const uint32_t*>(map_words);
  const uint16_t* map16 = static_cast<const uint16_t*>(map_words);
  const int ws = p.c * lt;  // stride of a staged plane
  const int32_t* keys_a = keys + l;
  const int32_t* keys_b = keys + (size_t)nk * ws + l;
  for (int o0 = o_first; o0 < o_end; o0 += rp * kMoveRows) {
    uint32_t e[kMoveRows];
#pragma unroll
    for (int u = 0; u < kMoveRows; ++u) {
      const int o = o0 + u * rp;
      if constexpr (kKeepAll) {
        e[u] = o < o_end ? map16[(size_t)o * lt + l] : kNone;
      } else {
        e[u] = o < o_end && o < total ? map[(size_t)o * lt + l] : 0xFFFFFFFFu;
      }
    }
    for (int k = 0; k < nk; ++k) {
#pragma unroll
      for (int u = 0; u < kMoveRows; ++u) {
        const int o = o0 + u * rp;
        if (o >= o_end) break;
        const uint32_t s = e[u] & kNone;
        int32_t x = kSentinel;
        if (s != kNone) x = ((s & 0x8000u) ? keys_b : keys_a)[k * ws + (int)(s & 0x7FFFu) * lt];
        p.out[k][(size_t)o * lanes + lane] = x;
      }
    }
    for (int v = 0; v < nv; ++v) {
      int32_t x[kMoveRows];
      if (vals != nullptr) {
        const int32_t* va = vals + (size_t)v * ws + l;
        const int32_t* vb = vals + (size_t)(nv + v) * ws + l;
#pragma unroll
        for (int u = 0; u < kMoveRows; ++u) {
          const uint32_t s = e[u] & kNone, s2 = kKeepAll ? kNone : e[u] >> 16;
          x[u] = s == kNone ? 0 : ((s & 0x8000u) ? vb : va)[(int)(s & 0x7FFFu) * lt];
          if (s2 != kNone) x[u] |= ((s2 & 0x8000u) ? vb : va)[(int)(s2 & 0x7FFFu) * lt];
        }
      } else {
        const int32_t* va = p.a[nk + v];
        const int32_t* vb = p.b[nk + v];
#pragma unroll
        for (int u = 0; u < kMoveRows; ++u) {
          const uint32_t s = e[u] & kNone;
          x[u] = s == kNone ? 0
                            : __ldg(((s & 0x8000u) ? vb : va) + (size_t)(s & 0x7FFFu) * lanes + lane);
        }
        if constexpr (!kKeepAll) {
#pragma unroll
          for (int u = 0; u < kMoveRows; ++u) {
            const uint32_t s = e[u] >> 16;
            if (s != kNone) {
              x[u] |= __ldg(((s & 0x8000u) ? vb : va) + (size_t)(s & 0x7FFFu) * lanes + lane);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kMoveRows; ++u) {
        const int o = o0 + u * rp;
        if (o < o_end) p.out[nk + v][(size_t)o * lanes + lane] = x[u];
      }
    }
  }
}

__device__ __forceinline__ bool aligned16(const Args& p, int first, int count) {
  bool ok = true;
  for (int k = first; k < first + count; ++k) {
    ok = ok && (reinterpret_cast<uintptr_t>(p.a[k]) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(p.b[k]) & 15) == 0;
  }
  return ok;
}

// The persistent walk over the tiles.  cp.async groups, committed in this
// order whatever is empty: keys of the first tile, its values; then a tile
// commits the next tile's keys at its top (two stages) or end (one stage)
// and the next tile's values at its end.  The rank waits for its keys, the
// move for its values.
template <int kKeys, bool kKeepAll>
__device__ __forceinline__ void run(const Args& p, int32_t* smem) {
  const int nk = kKeys ? kKeys : p.n_keys;
  const int nv = p.n_vals;
  const int lt = p.lt, t = threadIdx.x;
  const int c_shift = __ffs(p.c) - 1, lt_shift = __ffs(lt) - 1;
  const size_t key_words = (size_t)2 * nk * p.c * lt;
  int32_t* vals = p.stage_vals ? smem + p.stages * key_words : nullptr;
  uint32_t* map = reinterpret_cast<uint32_t*>(smem + p.stages * key_words +
                                              (p.stage_vals ? (size_t)2 * nv * p.c * lt : 0));
  int* warp_sums = kKeepAll ? reinterpret_cast<int*>(reinterpret_cast<uint16_t*>(map) +
                                                     (size_t)p.out_size * lt)
                            : reinterpret_cast<int*>(map + (size_t)p.out_size * lt);
  int* totals = warp_sums + kWarps * lt;
  const long long n_tiles = ((long long)p.lanes + lt - 1) >> lt_shift;
  const bool vec = lt % 4 == 0 && p.lanes % 4 == 0;
  const bool vec_keys = vec && aligned16(p, 0, nk);
  const bool vec_vals = vec && aligned16(p, nk, nv);

  auto load_values = [&](long long tile) {
    if (tile >= n_tiles) return;
    if (vals != nullptr) load_planes(p, nk, nv, vals, tile, vec_vals, c_shift, lt_shift);
    else prefetch_planes(p, nk, nv, tile, c_shift, lt_shift);
  };
  long long tile = blockIdx.x;
  if (tile < n_tiles) load_planes(p, 0, nk, smem, tile, vec_keys, c_shift, lt_shift);
  cp_async_commit();
  load_values(tile);
  cp_async_commit();
  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const int32_t* keys = smem + (it % p.stages) * key_words;
    const long long next = tile + gridDim.x;
    if (p.stages == 2) {
      if (next < n_tiles) {
        load_planes(p, 0, nk, smem + ((it + 1) % 2) * key_words, next, vec_keys, c_shift,
                    lt_shift);
      }
      cp_async_commit();
      cp_async_wait<2>();
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();
    int total;
    if constexpr (kKeepAll) {
      total = rank_keep_all<kKeys>(p, keys, reinterpret_cast<uint16_t*>(map));
    } else {
      total = rank_tile<kKeys>(p, keys, map, warp_sums);
    }
    const long long lane = (tile << lt_shift) + t;
    if (t < lt) {
      totals[t] = total;
      if (!kKeepAll && lane < p.lanes) p.n_unique[lane] = total;
    }
    if (p.stages == 2) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    move_rows<kKeys, kKeepAll>(p, keys, vals, map, totals, t % lt, lt,
                               (tile << lt_shift) + t % lt, t / lt, p.out_size, kThreads / lt);
    __syncthreads();
    if (p.stages == 1) {
      if (next < n_tiles) load_planes(p, 0, nk, smem, next, vec_keys, c_shift, lt_shift);
      cp_async_commit();
    }
    load_values(next);
    cp_async_commit();
  }
  cp_async_wait<0>();
}

template <int kKeys>
__global__ void __launch_bounds__(kThreads, 1) tile_union_kernel(Args p) {
  extern __shared__ int32_t smem[];
  run<kKeys, false>(p, smem);
}

template <int kKeys>
__global__ void __launch_bounds__(kThreads, 1) tile_merge_kernel(Args p) {
  extern __shared__ int32_t smem[];
  run<kKeys, true>(p, smem);
}

// Launch on `stream` with `smem` bytes a CTA (the host's figure, checked
// against the layout): as many persistent CTAs as the card holds at once,
// at most one a tile; the keep-all body (tile_merge_kernel) when
// `kKeepAll`, which takes out_size = 2C and no n_unique.  Returns a
// cudaError_t.
template <int kKeys, bool kKeepAll = false>
cudaError_t launch(const Args& p, int smem, cudaStream_t stream) {
  const bool lt_ok = p.lt == 1 || p.lt == 2 || p.lt == 4 || p.lt == 8;
  if (!lt_ok || (p.stages != 1 && p.stages != 2) || (p.stage_vals & ~1) || p.c < 1 ||
      p.c > kMaxRows || (p.c & (p.c - 1)) ||
      p.lanes <= 0 || p.n_keys < 1 || p.n_keys > kMaxKeys || p.n_vals < 0 ||
      p.n_keys + p.n_vals > kMaxPlanes || p.out_size < 0 || p.out_size > 2 * p.c ||
      (kKeepAll ? p.out_size != 2 * p.c : p.n_unique == nullptr) ||
      (kKeys && p.n_keys != kKeys) || smem < 0 || (size_t)smem < smem_bytes(p, kKeepAll)) {
    return cudaErrorInvalidValue;
  }
  void (*kernel)(Args);
  if constexpr (kKeepAll) kernel = tile_merge_kernel<kKeys>;
  else kernel = tile_union_kernel<kKeys>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = ((long long)p.lanes + p.lt - 1) / p.lt;
  const long long grid = tiles < (long long)per_sm * sms ? tiles : (long long)per_sm * sms;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tile_union
