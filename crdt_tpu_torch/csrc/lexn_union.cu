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
// Design.  lexn_union has two bodies; the host picks one by shape and shared
// memory (hopper_union.lexn_union_body) and passes its plan:
//   * the tile body (tile_union.cuh, lane_tile 8) where 2 sides x n_keys x
//     C rows x 8 lanes of key words fit a CTA — the OpLog's (2, 2) at
//     C = 1024 (164,384 B at out = C): each row of a tile's key planes is
//     one 32 B sector, loaded by cp.async 16 B a thread; merge-path ranks
//     with the heads in registers; a per-lane scan and a map of output row
//     -> source; the move gathers the value planes from device memory and
//     stores whole rows; persistent CTAs, one an SM;
//   * the wide body (stages 0) for the keys the tile does not take: RSeq's
//     (18, 2) / (18, 3) at C <= 1024, 5 key words, and narrow keys past the
//     tile's shared memory ((2, 2) at C = 2048 and 4096).  A cluster of 8
//     CTAs takes a tile of 8 adjacent lanes, each CTA owning one lane's
//     staged key rows, so a CTA's shared memory holds one lane's keys and
//     never the merged planes: 2·C·KP + 2C words and 2C flag bytes (KP =
//     n_keys rounded up to 4), 87,168 B at (18, ·), C = 512 and 174,208 B
//     at C = 1024.  It stages and ranks as lexn_merge does, then finishes
//     the union in the same launch where lexn_compact would read the merged
//     planes back from device memory: flags read through the map, one block
//     scan, the map rewritten in place into the compacted gather map, and a
//     move of out_size rows.  Past the card's 227 KB opt-in (C = 2048 at 18
//     words) the host stripes the union instead.
// The wide body's GC instance (lexn_gc_union, tomb_gc's GC join over RSeq)
// runs the join's floor rule in that same flag pass: a one-sided row that
// the other side's floor covers never enters the gather map, so the launch
// writes the joined lane's C rows, its n_unique after the rule and the
// rows the rule dropped, where the composition it replaces wrote a
// lossless 2C union with a side-marker plane and then sorted the holes
// away in plain torch (design above wide_union_kernel).
// Both take the key and value counts at run time (under kMaxPlanes planes a
// side; the tile body under tile_union::kMaxKeys key words).
// lexn_merge and lexn_compact (designs above their kernels) work on tiles
// of 8 adjacent lanes, so that every load and store of a row moves a whole
// 32 B sector: the merge as a cluster of 8 CTAs that trade the key words
// through distributed shared memory, the compaction as one CTA a tile that
// keeps only flags and a gather map.  Both put the lane-divergent side of
// the move on gathers that the L1 serves and store whole rows of the tile.
//
// What bounds them on this card: bytes.  At C=1024, L=10,240 the OpLog
// union reads 8 planes x C x L x 4 B = 335.5 MB and writes 167.8 MB: 0.150
// ms at 3.35 TB/s, against ~(C log C) integer compares a lane, which the
// card does far faster.  RSeq's 20-plane merge moves 3.36 GB (1.00 ms) and
// its compaction 2.52 GB (0.75 ms); the wide body's union at out = C moves
// 2.52 GB (0.75 ms) in one launch: it reads each key word from device
// memory once (flags and move take them from the owners' shared memory),
// the values once more where they are gathered, and writes no merged
// intermediate.  So does its GC instance, and 2 x W floor words a lane
// more.  At one or two lanes (the sequence soak's joins) nothing is
// bound by bytes: the launch, the cluster's barriers and the owner CTA's
// rank and scan set the time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_union.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int32_t kSentinel = 0x7FFFFFFF;
constexpr int kMaxPlanes = 32;  // per operand: n_keys + n_vals <= 32

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
  // the GC instance of the wide body alone (null / 0 elsewhere)
  const int32_t* floor_a;  // (n_writers, lanes): each side's per-writer floor
  const int32_t* floor_b;
  int32_t* dropped;        // (lanes,): rows the floor rule took out
  int n_writers;
  int seq_bits;            // identity word = rid << seq_bits | seq
};

// Block-wide exclusive scan of `cnt` (one count per thread, threads in
// order).  Returns the thread's exclusive prefix; *total gets the sum,
// which warp_sums[last warp] keeps.
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

// ---- lexn_merge: a cluster of 8 CTAs a tile of 8 adjacent lanes ----
//
// CTA `me` of a cluster owns lane l0 + me: its shared memory holds that
// lane's key words of A and B row by row (S rows of KP = n_keys rounded up
// to 4 words, the pad words 0) and the lane's merge map (2S words: output
// row -> A row i, or S + B row j).
//   1. stage: the cluster's CTAs split the rows; a thread reads four key
//      words of one row for its lane (8 threads read a row of the tile, one
//      32 B sector) and stores them as one 16 B store into the owner's
//      shared memory through distributed shared memory;
//   2. rank (local to the owner), by merge path: thread t finds by binary
//      search how many of the first t·K merged rows are A's (equal keys put
//      A's copy first), then merges its K = 4 rows in order — 2S/K searches
//      and 2S row compares a lane where a rank a row would take 2S
//      searches; a compare reads 16 B at a time;
//   3. move: the CTAs split the output rows; for each row of the tile the
//      8 lanes' sources come from the owners' maps; the key words come from
//      the owner's shared memory (16 B distributed loads, no second read of
//      them from device memory), the value planes from device memory (a
//      gather that the L1 serves, since neighbouring lanes read the same
//      sectors a few rows apart); every plane is stored as whole rows of the
//      tile.

constexpr int kTile = 8;             // lanes of a merge cluster or compaction tile
constexpr int kMergeThreads = 1024;  // 128 groups of 8 threads
constexpr int kMergeWarps = kMergeThreads / 32;
constexpr int kGroups = kMergeThreads / kTile;
constexpr int kRankRows = 4;        // merged rows a thread ranks after its search

// the key-word stride of a staged row: n_keys rounded up to 16 B
__host__ __device__ __forceinline__ int key_stride(int nk) { return (nk + 3) & ~3; }

// x < y over two staged rows of kp words (pad words equal)
__device__ __forceinline__ bool row_less(const int32_t* x, const int32_t* y, int kp) {
  for (int k = 0; k < kp; k += 4) {
    const int4 u = *reinterpret_cast<const int4*>(x + k);
    const int4 v = *reinterpret_cast<const int4*>(y + k);
    if (u.x != v.x) return u.x < v.x;
    if (u.y != v.y) return u.y < v.y;
    if (u.z != v.z) return u.z < v.z;
    if (u.w != v.w) return u.w < v.w;
  }
  return false;
}

// x == y over two staged rows of kp words
__device__ __forceinline__ bool row_equal(const int32_t* x, const int32_t* y, int kp) {
  for (int k = 0; k < kp; k += 4) {
    const int4 u = *reinterpret_cast<const int4*>(x + k);
    const int4 v = *reinterpret_cast<const int4*>(y + k);
    if (u.x != v.x || u.y != v.y || u.z != v.z || u.w != v.w) return false;
  }
  return true;
}

// Step 1 of the cluster kernels: CTA `me` stages rows [r0, r0 + nr) of both
// operands for the tile's 8 lanes into their owners' sa / sb (S x KP each);
// item (side, quad, row), rows fastest, so a warp reads 4 rows x 8 lanes of
// one word; a thread has kUnroll items' loads in flight before it stores.
template <int kThreadsT, int kUnroll>
__device__ __forceinline__ void stage_rows(const Params& p, cg::cluster_group& cluster,
                                           int32_t* sa, int32_t* sb, int s, int kp, int me,
                                           int l, int g, size_t lane, bool lane_ok) {
  constexpr int groups = kThreadsT / kTile;
  const size_t lanes = (size_t)p.lanes;
  int32_t* to_a = cluster.map_shared_rank(sa, l);
  int32_t* to_b = cluster.map_shared_rank(sb, l);
  const int per = (s + kTile - 1) / kTile;
  const int r0 = min(s, me * per), nr = min(s, r0 + per) - r0;
  const int quads = kp / 4;
  const int items = 2 * quads * nr;
  for (int w0 = g; lane_ok && w0 < items; w0 += groups * kUnroll) {
    int4 x[kUnroll];
    int32_t* to[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = w0 + u * groups;
      if (w < items) {
        const int r = r0 + w % nr, q = (w / nr) % quads, side = w / (nr * quads);
        int32_t y[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int k = 4 * q + v;
          y[v] = k < p.n_keys ? __ldg((side ? p.b[k] : p.a[k]) + (size_t)r * lanes + lane) : 0;
        }
        x[u] = make_int4(y[0], y[1], y[2], y[3]);
        to[u] = (side ? to_b : to_a) + r * kp + 4 * q;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (w0 + u * groups < items) *reinterpret_cast<int4*>(to[u]) = x[u];
    }
  }
}

// A's rows among the first d0 merged rows of the staged sa, sb (S rows
// each): A[mid] comes first iff !(B[d0 - mid - 1] < A[mid]), so equal keys
// put A's copy first.
__device__ __forceinline__ int co_rank(const int32_t* sa, const int32_t* sb, int s, int kp,
                                       int d0) {
  int lo = max(0, d0 - s), hi = min(d0, s);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!row_less(sb + (d0 - mid - 1) * kp, sa + mid * kp, kp)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kMergeThreads)
lexn_merge_kernel(Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nk = p.n_keys, np = p.n_keys + p.n_vals, kp = key_stride(nk);
  const int s = p.c, n = 2 * s;
  const size_t lanes = (size_t)p.lanes;
  const int me = (int)cluster.block_rank();
  const size_t l0 = (size_t)(blockIdx.x - me);  // the tile's first lane
  extern __shared__ int32_t smem[];
  int32_t* sa = smem;           // S x KP  A's key words of lane l0 + me
  int32_t* sb = sa + s * kp;    // S x KP  B's key words
  int32_t* map = sb + s * kp;   // 2S      output row -> source row

  const int l = threadIdx.x % kTile, g = threadIdx.x / kTile;
  const size_t lane = l0 + l;
  const bool lane_ok = lane < lanes;

  // 1. stage rows [r0, r0 + nr) of both operands.  The staging writes into
  // the other CTAs' shared memory, and CUDA promises that every CTA of a
  // cluster runs only after a cluster barrier: at small C two of these
  // CTAs share an SM and start at different times (the wide body faulted
  // now and then without this barrier)
  cluster.sync();
  stage_rows<kMergeThreads, 1>(p, cluster, sa, sb, s, kp, me, l, g, lane, lane_ok);
  cluster.sync();

  // 2. rank this CTA's own lane by merge path.
  if (l0 + me < lanes) {
    const int k_rows = max(kRankRows, (n + blockDim.x - 1) / blockDim.x);
    const int d0 = threadIdx.x * k_rows;
    if (d0 < n) {
      int ia = co_rank(sa, sb, s, kp, d0), ib = d0 - ia;
      for (int d = d0; d < min(n, d0 + k_rows); ++d) {
        const bool take_a = ia < s && (ib >= s || !row_less(sb + ib * kp, sa + ia * kp, kp));
        map[d] = take_a ? ia++ : s + ib++;
      }
    }
  }
  cluster.sync();

  // 3. move: CTA `me` writes output rows [o0, o1) of the 8 lanes.
  {
    const int32_t* from = cluster.map_shared_rank(map, l);
    const int32_t* keys_a = cluster.map_shared_rank(sa, l);
    const int per = (n + kTile - 1) / kTile;
    const int o0 = min(n, me * per), o1 = min(n, o0 + per);
    for (int o = o0 + g; lane_ok && o < o1; o += kGroups) {
      const int src = from[o];
      const size_t to = (size_t)o * lanes + lane;
      // keys: the owner's staged row (sb follows sa, so one base serves)
      const int32_t* row = keys_a + src * kp;
      for (int k = 0; k < nk; k += 4) {
        const int4 v = *reinterpret_cast<const int4*>(row + k);
        p.out[k][to] = v.x;
        if (k + 1 < nk) p.out[k + 1][to] = v.y;
        if (k + 2 < nk) p.out[k + 2][to] = v.z;
        if (k + 3 < nk) p.out[k + 3][to] = v.w;
      }
      const size_t from_row = (size_t)(src < s ? src : src - s) * lanes + lane;
      int32_t x[kMaxPlanes];
#pragma unroll
      for (int v = 0; v < kMaxPlanes; ++v) {
        if (v >= nk && v < np) x[v] = __ldg((src < s ? p.a[v] : p.b[v]) + from_row);
      }
#pragma unroll
      for (int v = 0; v < kMaxPlanes; ++v) {
        if (v >= nk && v < np) p.out[v][to] = x[v];
      }
    }
  }
  // no CTA may leave while another still reads its shared memory
  cluster.sync();
}

// ---- lexn_union's wide body: a cluster of 8 CTAs a tile of 8 lanes ----
//
// Staging and ranking are lexn_merge's (steps 1-2 above; two staging items
// in flight a thread, the value rows of the CTA's staging range prefetched
// into L2 for the move; K = max(2, 2C / threads) rows a thread); the owner
// CTA then punches and compacts its lane where lexn_compact would read the
// merged planes back from device memory.  Shared memory a CTA: sa, sb (C x
// KP each), the map (2C words), the scan's warp sums (kMergeWarps words;
// the last warp's ends as the lane's n_unique) and a flag byte a merged
// row — wide_smem_bytes, the host's hopper_union.lexn_wide_smem_bytes.
// Instances of 1,024 / k threads for k = 1, 2, 4, 8 CTAs an SM; the host
// takes the most CTAs whose shared memory fits an SM, so that one
// cluster's barriers and rank overlap another's loads and stores (two of
// 512 threads at RSeq's C = 512, 87,168 B: 2.22 -> 1.47 ms at (18, 2),
// L = 10,240, device time on an NVIDIA H100 80GB HBM3 at 700 W; one of
// 1,024 at C = 1024, 174,208 B; eight of 128 at tiny C).
//   2. while it merges its K rows in order, a thread flags each: padding
//      (key word 0 is SENTINEL), a duplicate (not padding, and equal to the
//      merged row before it: 16 B compares in shared memory; a run's first
//      row compares with the later of A[ia - 1] and B[ib - 1]) or kept;
//   3. one block scan of the kept counts over the threads' runs gives
//      n_unique (before truncation) and each kept row its output row; each
//      thread reads its run's map entries and flags, and the next run's
//      first, before the scan's barriers, and rewrites the map in place
//      after them into the compacted gather map: output row k -> its source
//      (bits 0-15), and where the next merged row is a duplicate, bit 31
//      and that row's source (bits 16-30), whose values OR in (lexn_compact's
//      window rule);
//   4. cluster.sync, then the move over out_size rows, as lexn_merge's step
//      3: CTA `me` writes rows [o0, o1) of the tile's 8 lanes, the key words
//      from the owner's staged row (distributed shared memory), the values
//      gathered from A and B in device memory with the duplicate's ORed in,
//      every plane stored as whole rows of the tile; rows at or past the
//      lane's n_unique (read from the owner) are SENTINEL / 0.
// At fewer than 8 lanes only the owners of real lanes rank and scan, while
// all 8 CTAs stage and move.
//
// The GC instance (kGc, the GC join of tomb_gc over RSeq: lexn_gc_union)
// adds the floor rule to step 3.  Step 1 also loads the owner lane's floor
// column of each side (2 x n_writers words, after the warp sums).  In step
// 3 a kept row is dropped where the next merged row is not its duplicate
// (the row is one-sided: no matched pair is ever dropped) and the OTHER
// side's floor covers its identity word, the last key word of the staged
// row: rid = ident >> seq_bits in [0, n_writers) and seq <= floor[rid].
// The side comes from the map (src < C: A, whose rows B's floor covers).
// A thread counts kept rows in the low 16 bits of its scan count and
// dropped rows in the high bits, so the one block scan gives both; the
// lane's n_unique is then the kept rows after the floor rule and before
// truncation, and `dropped` gets the rest.  The move is step 4 as it
// stands: a dropped row was never written to the gather map, so out_size
// = C rows of the compacted lane come out of the one launch.

constexpr int kWideMinRows = 2;   // merged rows a thread takes at least
constexpr int kWideRankRows = 8;  // and at most
constexpr int kWideUnroll = 2;    // staging items in flight a thread
constexpr int32_t kDupBit = (int32_t)0x80000000u;

// n_writers: the GC instance's floor words of each side (0 for the union)
__host__ __device__ inline size_t wide_smem_bytes(int nk, int c, int n_writers = 0) {
  return sizeof(int32_t) * ((size_t)2 * c * key_stride(nk) + 2 * (size_t)c + kMergeWarps +
                            2 * (size_t)n_writers) +
         2 * (size_t)c;
}

// The GC instance's scan count: kept rows in the low 16 bits (2C <= 8,192
// rows a lane), dropped rows above them.
constexpr int kDropShift = 16;
constexpr int kKeptMask = (1 << kDropShift) - 1;

template <int kWideThreads, int kCtasPerSm, bool kGc>
__global__ void __launch_bounds__(kWideThreads, kCtasPerSm)
wide_union_kernel(Params p) {
  constexpr int groups = kWideThreads / kTile, warps = kWideThreads / 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int nk = p.n_keys, np = p.n_keys + p.n_vals, kp = key_stride(nk);
  const int c = p.c, n = 2 * c;
  const size_t lanes = (size_t)p.lanes;
  const int me = (int)cluster.block_rank();
  const size_t l0 = (size_t)(blockIdx.x - me);  // the tile's first lane
  extern __shared__ int32_t smem[];
  int32_t* sa = smem;           // C x KP  A's key words of lane l0 + me
  int32_t* sb = sa + c * kp;    // C x KP  B's key words
  int32_t* map = sb + c * kp;   // 2C      merged row -> source, then the gather map
  int* warp_sums = map + n;     // kMergeWarps
  int32_t* floors = warp_sums + kMergeWarps;  // GC: n_writers words of A's floor, then B's
  const int fw = kGc ? p.n_writers : 0;
  unsigned char* flag = reinterpret_cast<unsigned char*>(floors + 2 * fw);  // 2C

  const int l = threadIdx.x % kTile, g = threadIdx.x / kTile;
  const size_t lane = l0 + l;
  const bool lane_ok = lane < lanes;

  // 1. stage the keys; the value rows of the same range go to L2 for the
  // move.  The first barrier makes sure every CTA of the cluster runs
  // before any writes into its shared memory: with several CTAs an SM they
  // start at different times (without it the 128-thread instance faulted
  // now and then at C = 64)
  cluster.sync();
  stage_rows<kWideThreads, kWideUnroll>(p, cluster, sa, sb, c, kp, me, l, g, lane, lane_ok);
  {
    const int per = (c + kTile - 1) / kTile;
    const int r0 = min(c, me * per), nr = min(c, r0 + per) - r0;
    const int nv = p.n_vals;
    for (int w = threadIdx.x; w < 2 * nv * nr; w += kWideThreads) {
      const int r = r0 + w % nr, v = nk + (w / nr) % nv, side = w / (nr * nv);
      tile_union::prefetch_l2((side ? p.b[v] : p.a[v]) + (size_t)r * lanes + l0);
    }
  }
  if (kGc && l0 + me < lanes) {  // the owner lane's floor column of each side
    for (int w = threadIdx.x; w < 2 * fw; w += kWideThreads) {
      floors[w] = __ldg((w < fw ? p.floor_a : p.floor_b) + (size_t)(w % fw) * lanes + l0 + me);
    }
  }
  cluster.sync();

  if (l0 + me < lanes) {  // the same for every thread of the CTA
    const int k_rows = max(kWideMinRows, (n + kWideThreads - 1) / kWideThreads);
    const int d0 = min(n, (int)threadIdx.x * k_rows), d1 = min(n, d0 + k_rows);

    // 2. rank and flag the run [d0, d1)
    if (d0 < d1) {
      int ia = co_rank(sa, sb, c, kp, d0), ib = d0 - ia;
      const int32_t* prev = nullptr;
      if (d0 > 0) {  // the merged row before d0: the later of A[ia - 1], B[ib - 1]
        const int32_t* pa = sa + (ia - 1) * kp;
        const int32_t* pb = sb + (ib - 1) * kp;
        prev = ib == 0 ? pa : ia == 0 ? pb : row_less(pb, pa, kp) ? pa : pb;
      }
      for (int d = d0; d < d1; ++d) {
        const bool take_a = ia < c && (ib >= c || !row_less(sb + ib * kp, sa + ia * kp, kp));
        const int src = take_a ? ia++ : c + ib++;
        const int32_t* row = sa + src * kp;  // sb follows sa
        map[d] = src;
        flag[d] = row[0] == kSentinel ? 2 : (prev != nullptr && row_equal(row, prev, kp));
        prev = row;
      }
    }
    __syncthreads();

    // 3. scan, then the gather map
    int src[kWideRankRows + 1], fl[kWideRankRows + 1];
    int cnt = 0;
#pragma unroll
    for (int k = 0; k <= kWideRankRows; ++k) {
      const bool in = k <= k_rows && d0 + k < n;
      src[k] = in ? map[d0 + k] : 0;
      fl[k] = in ? flag[d0 + k] : 2;
      if (k < k_rows && d0 + k < d1) cnt += fl[k] == 0;
    }
    if (kGc) {  // the floor rule: a one-sided kept row the other side's floor covers
      const uint32_t seq_mask = (1u << p.seq_bits) - 1u;
#pragma unroll
      for (int k = 0; k < kWideRankRows; ++k) {
        if (k < k_rows && d0 + k < d1 && fl[k] == 0 && fl[k + 1] != 1) {
          const int32_t ident = sa[src[k] * kp + nk - 1];
          const int rid = ident >> p.seq_bits;
          const int seq = (int)((uint32_t)ident & seq_mask);
          const int32_t* other = src[k] < c ? floors + fw : floors;
          if (rid >= 0 && rid < fw && seq <= other[rid]) {
            fl[k] = 3;
            cnt += (1 << kDropShift) - 1;  // from the kept count to the dropped
          }
        }
      }
    }
    int total;
    int dst = block_exclusive_scan(cnt, warp_sums, &total);
    if (kGc) dst &= kKeptMask;
#pragma unroll
    for (int k = 0; k < kWideRankRows; ++k) {
      if (k < k_rows && d0 + k < d1 && fl[k] == 0) {
        map[dst++] = fl[k + 1] == 1 ? (src[k] | src[k + 1] << 16 | kDupBit) : src[k];
      }
    }
    if (threadIdx.x == 0) {
      p.n_unique[l0 + me] = kGc ? total & kKeptMask : total;
      if (kGc) p.dropped[l0 + me] = total >> kDropShift;
    }
  }
  cluster.sync();

  // 4. move: CTA `me` writes output rows [o0, o1) of the 8 lanes.
  {
    const int32_t* gather = cluster.map_shared_rank(map, l);
    const int32_t* keys = cluster.map_shared_rank(sa, l);
    const int sum = lane_ok ? cluster.map_shared_rank(warp_sums, l)[warps - 1] : 0;
    const int nu = kGc ? sum & kKeptMask : sum;
    const int out = p.out_size;
    const int per = (out + kTile - 1) / kTile;
    const int o0 = min(out, me * per), o1 = min(out, o0 + per);
    for (int o = o0 + g; lane_ok && o < o1; o += groups) {
      const size_t to = (size_t)o * lanes + lane;
      if (o >= nu) {
#pragma unroll
        for (int v = 0; v < kMaxPlanes; ++v) {
          if (v < np) p.out[v][to] = v < nk ? kSentinel : 0;
        }
        continue;
      }
      const int32_t e = gather[o];
      const int s0 = e & 0xFFFF;
      const int32_t* row = keys + s0 * kp;
      for (int k = 0; k < nk; k += 4) {
        const int4 v = *reinterpret_cast<const int4*>(row + k);
        p.out[k][to] = v.x;
        if (k + 1 < nk) p.out[k + 1][to] = v.y;
        if (k + 2 < nk) p.out[k + 2][to] = v.z;
        if (k + 3 < nk) p.out[k + 3][to] = v.w;
      }
      const size_t from0 = (size_t)(s0 < c ? s0 : s0 - c) * lanes + lane;
      int32_t x[kMaxPlanes];
#pragma unroll
      for (int v = 0; v < kMaxPlanes; ++v) {
        if (v >= nk && v < np) x[v] = __ldg((s0 < c ? p.a[v] : p.b[v]) + from0);
      }
      if (e < 0) {
        const int s1 = (e >> 16) & 0x7FFF;
        const size_t from1 = (size_t)(s1 < c ? s1 : s1 - c) * lanes + lane;
#pragma unroll
        for (int v = 0; v < kMaxPlanes; ++v) {
          if (v >= nk && v < np) x[v] |= __ldg((s1 < c ? p.a[v] : p.b[v]) + from1);
        }
      }
#pragma unroll
      for (int v = 0; v < kMaxPlanes; ++v) {
        if (v >= nk && v < np) p.out[v][to] = x[v];
      }
    }
  }
  // no CTA may leave while another still reads its shared memory
  cluster.sync();
}

// ---- lexn_compact: one CTA a tile of LT adjacent lanes ----
//
// LT (8, or 4, 2, 1 for columns too long for 8) is the host's choice by
// shared memory (hopper_union.lexn_compact_tile).  Shared memory holds one
// flag byte a row a lane, the per-lane scan and a window of the gather map;
// keys and values stay in device memory.
//   1. flags: warp w walks its own run of rows, 32/LT rows x LT lanes a
//      step, so each warp load is whole sectors — 16 B a thread (4 lanes)
//      where the tile is 8 lanes, L a multiple of 4 and the key planes 16 B
//      aligned, else 4 B; the row above comes from the neighbouring thread
//      by a shuffle (a reload from L1 for the step's first row), so each key
//      word is read from device memory once;
//   2. scan: one exclusive scan of the keep flags per lane, segmented over
//      the tile, each thread owning a run of consecutive rows;
//   3. move, in windows of output rows: each thread walks its run and writes
//      the source row of each kept row (bit 31: the next row is a duplicate
//      whose values OR in) into the window; then each thread gathers every
//      plane of its rows from device memory, all planes of a row in flight
//      together (the L1 serves the lanes' neighbouring sources), and the
//      warps store whole rows of the tile; rows at or past a lane's
//      n_unique are SENTINEL/0.

constexpr int kCompactThreads = 256;
constexpr int kCompactWarps = kCompactThreads / 32;
constexpr int kWindowWords = 8192;  // gather map entries (rows x LT) a window
constexpr int kKeyBatch = 8;        // key words loaded together in the flag pass

__global__ void __launch_bounds__(kCompactThreads)
lexn_compact_kernel(Params p, int lt) {
  const int nk = p.n_keys, np = p.n_keys + p.n_vals;
  const int n = p.c;
  const size_t lanes = (size_t)p.lanes;
  const size_t l0 = (size_t)blockIdx.x * lt;
  extern __shared__ int32_t smem[];
  int* warp_sums = smem;                                  // kCompactWarps x kTile
  int32_t* window = warp_sums + kCompactWarps * kTile;    // kWindowWords
  unsigned char* flag = reinterpret_cast<unsigned char*>(window + kWindowWords);  // n x LT

  const int t = threadIdx.x, wid = t / 32, wl = t % 32;
  const int l = t % lt;
  const size_t lane = l0 + l;
  const bool lane_ok = lane < lanes;

  // 1. flags.  bit 0: a duplicate of the row above; bit 1: padding (key
  // word 0 is SENTINEL, or a lane past the last).  Kept when 0.
  bool vec = lt == kTile && lanes % 4 == 0;
  for (int k = 0; k < nk; ++k) vec = vec && (reinterpret_cast<uintptr_t>(p.a[k]) & 15) == 0;
  const int per_warp = (n + kCompactWarps - 1) / kCompactWarps;
  const int w0 = min(n, wid * per_warp), w1 = min(n, w0 + per_warp);
  if (vec) {
    // 16 B a thread: two threads a row of the tile, 16 rows a warp step
    const int i = wl / 2, h = wl % 2;
    const size_t lane4 = l0 + 4 * h;
    const bool ok4 = lane4 < lanes;
    for (int base = w0; base < w1; base += 16) {
      const int r = base + i;
      const bool ok = ok4 && r < w1;
      const size_t row = (size_t)r * lanes + lane4;
      bool e0 = r > 0, e1 = e0, e2 = e0, e3 = e0;
      int4 first = make_int4(kSentinel, kSentinel, kSentinel, kSentinel);
      for (int k0 = 0; k0 < nk; k0 += 4) {
        int4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          v[u] = ok && k0 + u < nk ? __ldg(reinterpret_cast<const int4*>(p.a[k0 + u] + row))
                                   : make_int4(0, 0, 0, 0);
        }
        if (k0 == 0) first = v[0];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          int4 up;
          up.x = __shfl_up_sync(0xffffffffu, v[u].x, 2);
          up.y = __shfl_up_sync(0xffffffffu, v[u].y, 2);
          up.z = __shfl_up_sync(0xffffffffu, v[u].z, 2);
          up.w = __shfl_up_sync(0xffffffffu, v[u].w, 2);
          if (i == 0 && ok && r > 0 && k0 + u < nk) {
            up = __ldg(reinterpret_cast<const int4*>(p.a[k0 + u] + row - lanes));
          }
          e0 = e0 && v[u].x == up.x;
          e1 = e1 && v[u].y == up.y;
          e2 = e2 && v[u].z == up.z;
          e3 = e3 && v[u].w == up.w;
        }
      }
      if (r < w1) {
        uint32_t f = 0x02020202u;
        if (ok) {
          const bool p0 = first.x == kSentinel, p1 = first.y == kSentinel,
                     p2 = first.z == kSentinel, p3 = first.w == kSentinel;
          f = ((e0 && !p0) | (p0 << 1)) | (((e1 && !p1) | (p1 << 1)) << 8) |
              (((e2 && !p2) | (p2 << 1)) << 16) | (((e3 && !p3) | (p3 << 1)) << 24);
        }
        *reinterpret_cast<uint32_t*>(flag + r * lt + 4 * h) = f;
      }
    }
  } else {
    const int rows_per_step = 32 / lt, i = wl / lt;
    for (int base = w0; base < w1; base += rows_per_step) {
      const int r = base + i;
      const bool ok = lane_ok && r < w1;
      const size_t row = (size_t)r * lanes + lane;
      bool eq = r > 0;
      int32_t w0v = kSentinel;
      for (int k0 = 0; k0 < nk; k0 += kKeyBatch) {
        int32_t v[kKeyBatch];
#pragma unroll
        for (int u = 0; u < kKeyBatch; ++u) {
          v[u] = ok && k0 + u < nk ? __ldg(p.a[k0 + u] + row) : 0;
        }
        if (k0 == 0) w0v = v[0];
#pragma unroll
        for (int u = 0; u < kKeyBatch; ++u) {
          int32_t up = __shfl_up_sync(0xffffffffu, v[u], lt);
          if (i == 0 && ok && r > 0 && k0 + u < nk) up = __ldg(p.a[k0 + u] + row - lanes);
          eq = eq && (k0 + u >= nk || v[u] == up);
        }
      }
      if (ok) {
        const bool pad = w0v == kSentinel;
        flag[r * lt + l] = (eq && !pad ? 1 : 0) | (pad ? 2 : 0);
      } else if (r < w1) {
        flag[r * lt + l] = 2;
      }
    }
  }
  __syncthreads();

  // 2. scan.  Thread t runs rows [c·per, (c+1)·per) of lane l, c = t / lt;
  // threads of one lane are lt apart, so the warp scan steps by lt.
  const int chunks = kCompactThreads / lt, c = t / lt;
  const int per = (n + chunks - 1) / chunks;
  const int r0 = min(n, c * per), r1 = min(n, r0 + per);
  int cnt = 0;
  for (int r = r0; r < r1; ++r) cnt += flag[r * lt + l] == 0;
  int incl = cnt;
  for (int o = lt; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (wl >= o) incl += y;
  }
  if (wl >= 32 - lt) warp_sums[wid * kTile + l] = incl;
  __syncthreads();
  int dst = incl - cnt, total = 0;
  for (int w = 0; w < kCompactWarps; ++w) {
    const int x = warp_sums[w * kTile + l];
    if (w < wid) dst += x;
    total += x;
  }
  if (c == 0 && lane_ok) p.n_unique[lane] = total;

  // 3. move, window by window of output rows; thread t moves rows
  // o0 + c, o0 + c + chunks, ... of lane l (a warp: whole rows of the
  // tile), every plane of a row loaded before any is stored.
  const int win_rows = kWindowWords / lt;
  int pos = r0;
  for (int o0 = 0; o0 < p.out_size; o0 += win_rows) {
    const int o1 = min(p.out_size, o0 + win_rows);
    for (; pos < r1; ++pos) {
      if (flag[pos * lt + l] != 0) continue;
      if (dst >= o1) break;
      const bool next_dup = pos + 1 < n && (flag[(pos + 1) * lt + l] & 1);
      window[(dst - o0) * lt + l] = pos | (next_dup ? (int32_t)0x80000000 : 0);
      ++dst;
    }
    __syncthreads();
    for (int o = o0 + c; lane_ok && o < o1; o += chunks) {
      const size_t to = (size_t)o * lanes + lane;
      if (o >= total) {
        for (int v = 0; v < np; ++v) p.out[v][to] = v < nk ? kSentinel : 0;
        continue;
      }
      const int32_t sw = window[(o - o0) * lt + l];
      const size_t src = (size_t)(sw & 0x7fffffff) * lanes + lane;
      int32_t x[kMaxPlanes];
#pragma unroll
      for (int v = 0; v < kMaxPlanes; ++v) {
        if (v < np) x[v] = __ldg(p.a[v] + src);
      }
      if (sw < 0) {
#pragma unroll
        for (int v = 0; v < kMaxPlanes; ++v) {
          if (v >= nk && v < np) x[v] |= __ldg(p.a[v] + src + lanes);
        }
      }
#pragma unroll
      for (int v = 0; v < kMaxPlanes; ++v) {
        if (v < np) p.out[v][to] = x[v];
      }
    }
    __syncthreads();
  }
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

// A cluster kernel's launch (lexn_merge, the wide union): ceil(lanes / 8)
// clusters of 8 CTAs, `smem` bytes a CTA.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, int lanes, int smem, cudaStream_t stream,
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((lanes + kTile - 1) / kTile * kTile);
  cfg->blockDim = dim3(kMergeThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kTile;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// The merge's launch; *clusters gets how many clusters the card can hold
// at once.
cudaError_t merge_config(int lanes, int smem, cudaStream_t stream,
                         cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                         int* clusters) {
  cudaError_t err = cluster_config(lexn_merge_kernel, lanes, smem, stream, cfg, attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(clusters, (void*)lexn_merge_kernel, cfg);
}

template <bool kGc>
void (*wide_instance(int ctas_per_sm))(Params) {
  return ctas_per_sm == 8   ? wide_union_kernel<128, 8, kGc>
         : ctas_per_sm == 4 ? wide_union_kernel<256, 4, kGc>
         : ctas_per_sm == 2 ? wide_union_kernel<512, 2, kGc>
                            : wide_union_kernel<1024, 1, kGc>;
}

// The wide union's launch, after the checks of what it takes: the plan
// (8 lanes a cluster, stages 0, `ctas_per_sm` 1, 2, 4 or 8), C a power of
// two with 2C <= kWideRankRows x the instance's threads, and `smem` at
// least its layout's; the GC instance (`gc`) also its floors, its dropped
// counts and a seq_bits under 32.  k CTAs an SM run the instance of
// 1,024 / k threads, each held to 64 registers.
cudaError_t wide_launch(const Params& p, int lane_tile, int ctas_per_sm, int smem,
                        cudaStream_t stream, bool gc = false) {
  void (*kernel)(Params) = gc ? wide_instance<true>(ctas_per_sm)
                              : wide_instance<false>(ctas_per_sm);
  const int threads = 1024 / ctas_per_sm;
  if (lane_tile != kTile || (ctas_per_sm != 1 && ctas_per_sm != 2 && ctas_per_sm != 4 &&
                             ctas_per_sm != 8) || (p.c & (p.c - 1)) ||
      2 * p.c > kWideRankRows * threads || p.out_size < 0 || p.out_size > 2 * p.c ||
      p.n_unique == nullptr || smem < 0 ||
      (size_t)smem < wide_smem_bytes(p.n_keys, p.c, gc ? p.n_writers : 0)) {
    return cudaErrorInvalidValue;
  }
  if (gc && (p.floor_a == nullptr || p.floor_b == nullptr || p.dropped == nullptr ||
             p.n_writers < 0 || p.seq_bits < 0 || p.seq_bits > 31)) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, p.lanes, smem, stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  cfg.blockDim = dim3(threads);
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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
// `stages` 0 runs the wide body (`lane_tile` 8: the lanes of a cluster;
// `stage_vals` is then its CTAs an SM, 1 or 2); 1 or 2 the tile body with
// `lane_tile` lanes a tile (1, 2, 4 or 8), that many key buffers and the
// value planes staged (`stage_vals` 1) or gathered from device memory (0).
int lexn_union(int n_keys, int n_vals, const void* const* a,
               const void* const* b, void* const* out, void* n_unique, int c,
               int lanes, int out_size, int lane_tile, int stages,
               int stage_vals, int smem, void* stream) {
  Params p;
  if (!fill_params(&p, n_keys, n_vals, a, b, out, n_unique, c, lanes, out_size)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stages == 0) return wide_launch(p, lane_tile, stage_vals, smem, s);
  tile_union::Args t = {};
  for (int i = 0; i < n_keys + n_vals; ++i) {
    t.a[i] = p.a[i];
    t.b[i] = p.b[i];
    t.out[i] = p.out[i];
  }
  t.n_unique = p.n_unique;
  t.c = c;
  t.lanes = lanes;
  t.out_size = out_size;
  t.n_keys = n_keys;
  t.n_vals = n_vals;
  t.lt = lane_tile;
  t.stages = stages;
  t.stage_vals = stage_vals;
  if (n_keys == 2) return tile_union::launch<2>(t, smem, s);
  return tile_union::launch<0>(t, smem, s);
}

// The GC join's union (the wide body's GC instance): the union's operands
// and plan (`lane_tile` 8, `ctas_per_sm`), each side's floor plane
// (n_writers, lanes) and the identity words' seq_bits; outputs (c, lanes):
// a GC join writes the joined lane's capacity, never more; n_unique and
// dropped (lanes,): the kept rows after the floor rule (before truncation)
// and the rows it took out.
int lexn_gc_union(int n_keys, int n_vals, const void* const* a, const void* const* b,
                  const void* floor_a, const void* floor_b, void* const* out,
                  void* n_unique, void* dropped, int c, int lanes, int n_writers,
                  int seq_bits, int lane_tile, int ctas_per_sm, int smem, void* stream) {
  Params p;
  if (!fill_params(&p, n_keys, n_vals, a, b, out, n_unique, c, lanes, c)) {
    return cudaErrorInvalidValue;
  }
  p.floor_a = static_cast<const int32_t*>(floor_a);
  p.floor_b = static_cast<const int32_t*>(floor_b);
  p.dropped = static_cast<int32_t*>(dropped);
  p.n_writers = n_writers;
  p.seq_bits = seq_bits;
  return wide_launch(p, lane_tile, ctas_per_sm, smem, static_cast<cudaStream_t>(stream), true);
}

// The merge: inputs (s, lanes), outputs (2s, lanes); clusters of 8 CTAs.
// cudaErrorLaunchOutOfResources when the card cannot place one cluster at
// `smem` bytes a CTA.
int lexn_merge(int n_keys, int n_vals, const void* const* a,
               const void* const* b, void* const* out, int s, int lanes,
               int smem, void* stream) {
  Params p;
  if (!fill_params(&p, n_keys, n_vals, a, b, out, nullptr, s, lanes, 2 * s)) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  cudaError_t err = merge_config(p.lanes, smem, static_cast<cudaStream_t>(stream),
                                 &cfg, &attr, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, lexn_merge_kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of the merge that the card can hold at once at `smem` bytes a
// CTA (cudaOccupancyMaxActiveClusters), or minus the error code.
int lexn_merge_clusters(int smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  cudaError_t err = merge_config(kTile, smem, nullptr, &cfg, &attr, &clusters);
  return err != cudaSuccess ? -static_cast<int>(err) : clusters;
}

// The compaction: inputs (n, lanes) sorted per lane, outputs (out_size,
// lanes), n_unique (lanes,); `lane_tile` lanes a CTA (8, 4, 2 or 1).
int lexn_compact(int n_keys, int n_vals, const void* const* planes,
                 void* const* out, void* n_unique, int n, int lanes,
                 int out_size, int lane_tile, int smem, void* stream) {
  Params p;
  if (!fill_params(&p, n_keys, n_vals, planes, nullptr, out, n_unique, n, lanes,
                   out_size) ||
      lane_tile < 1 || lane_tile > kTile || (lane_tile & (lane_tile - 1))) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      lexn_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = (lanes + lane_tile - 1) / lane_tile;
  lexn_compact_kernel<<<grid, kCompactThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p, lane_tile);
  return cudaGetLastError();
}

const char* lexn_union_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
