// Cluster-KNN sweep: top-k GoldFinger-Jaccard database neighbours of every
// query row, for a batch of independent (query set, database set) pairs.
//
// Replaces the TPU kernel src/repro/kernels/goldfinger_knn/goldfinger_knn.py
// ::knn_pallas (body _knn_kernel), which C² build Step 2 reaches through
// core/local_knn.py::_pallas_group_knn -> ops.cluster_knn.
//
// What bounds it. Per batch of c rows, c^2 intersections of W packed words
// against c * (4W + 8) bytes read and c * k * 8 written: at the main path's
// W = 32, as int8 bit-plane products, about 2,000 tensor-core operations
// for every byte, so the least time is set by operations. What the card
// actually spends goes to three things (repro_torch.bench.
// cluster_knn_phases): the intersections, because mma.sync .b1 runs at
// about 15% of the int8 rate (NVIDIA H100 80GB HBM3, 700 W); keeping the
// exact top-k of every row; and the few large clusters of Step 2, whose
// launches fill only part of the 132 SMs.
//
// Design. One block per (batch, tile of 16 query rows) -- one mma M -- so
// a cap-c batch has c/16 blocks per cluster; a block whose 16 query ids are
// all PAD writes PAD/-inf and returns. The database axis is cut into tiles
// of 32 rows and walked in steps of NW tiles, NW the block's warps:
//   1. staging: warp w's tiles are w, w + NW, ...; its next tile (W words,
//      card and id per row) is copied by cp.async into the warp's own
//      `stages`-deep ring while it works on the current one -- 16-byte
//      copies when W % 4 == 0 and the tables are 16-byte aligned, else
//      4-byte. A tile whose 32 ids are all PAD is skipped (each tile is
//      tested: PAD may sit anywhere);
//   2. intersections: warp w computes its tile's 16 x 32 intersections as
//      four m16n8 int32 C fragments of mma.sync m16n8k256 .b1 AND-popc on
//      the packed words (W zero-padded to a multiple of 8 words in the query
//      tile, so the padding adds 0): exact integers, the reference's int8
//      bit-plane product. Of the three forms timed on the card in this
//      tiling (repro_torch.bench.intersect_forms, W = 32; NVIDIA H100
//      80GB HBM3, 700 W), .b1 was 1.6-2.6x faster than __popc on the CUDA
//      cores and 4.2-6.9x faster than .s8 mma on unpacked bit planes;
//   3. keys: each candidate gets one 64-bit key, high word the sim's
//      order-preserving bit pattern, low word 0xFFFFFFFF - column, so a
//      larger key is exactly (sim desc, column asc) -- the reference's
//      order (a stable descending sort: ties to the lowest column). PAD,
//      self and out-of-range pairs get key 0, below every other. Warp w
//      writes its tile's keys into the step's key tile (double-buffered,
//      one barrier per step);
//   4. top-k: warp w keeps the top-k of rows w, w + NW, ...: per row the
//      best KP keys (KP = 32 or 64, one or two per lane, sorted) and a
//      32-key buffer. Over the step's NW tiles a candidate is buffered only
//      if its key beats the row's current k-th key; when a buffer would
//      overflow, it is bitonic-sorted across the lanes and merged into its
//      list (half-cleaner against the reversed buffer, then a bitonic
//      merge, all by warp shuffles; a warp's rows two or four at a time, so
//      their shuffle chains interleave), which raises the k-th key. For
//      k > 64 a row's list (KP = k rounded up to 32 keys) is merged where
//      it lies, in shared memory or, when 16 of them do not fit there
//      beside the tiles, in a global workspace (flush_row_mem: each key
//      moves to its rank in the merged list, found by binary search).
// Calls of more than 65,535 clusters, the grid's y limit, are split into
// launches by the wrapper; where a cluster lands does not enter its result.
// Rows too wide for this layout (W above ~1,100 words, as raw incidence
// rows are: 5,355 words on AM) take the WIDE instances: the words axis
// streams through the block in chunks of `chunk` words (a multiple of 8,
// so every m16n8k256 k-step is whole). Query chunks and each warp's tile
// chunks share the `stages`-deep ring, one block barrier on either side of
// each chunk; the four int32 C fragments of a tile accumulate over the
// chunks, so the intersection is the same exact integer and keys and
// top-k are as above. Words past W in the last chunk are zero in the query
// chunk, so the stale words beside them in the ring add 0. Shared memory
// then does not grow with W.
// At the end each warp flushes its rows' buffers and writes the rows out.
// The order is total (no two candidates share a column), so the top-k does
// not depend on the order in which candidates arrive or on the filtering
// against a k-th key that lags behind: the result is bitwise the serial
// top-k. A row's list lives in one warp, not one per warp merged at the
// end, because each list first takes k keys unfiltered: per-warp lists of
// all 16 rows paid that 8 times a row, and the main path's Step-2
// launches took 1.53 ms of device time against 0.86 ms this way
// (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W). The epilogue is
// repro::jaccard_sim (IEEE f32, as the reference); slots with no key come
// out PAD/-inf.

#include "keys.cuh"

namespace {

constexpr int kRows = 16;       // query rows per block (mma M)
constexpr int kTile = 32;       // database rows per warp tile (one per lane)
constexpr unsigned kFull = 0xffffffffu;

using repro::bitonic_desc;
using repro::Key;
using repro::kmax;
using repro::kmin;
using repro::sort_asc;

// Byte offsets of the block's dynamic shared memory.
struct Layout {
  int ws;              // words per staged row: W (or the chunk) padded to
                       // 8, plus 4
  int ks;              // keys per row of a key tile: 32 per warp, plus 8
  size_t q_words;      // uint32 [16][ws]; chunked: [stages][16][ws]
  size_t q_id;         // int [16]
  size_t q_card;       // int [16]
  size_t live;         // int [2][warps]: the step's tile of warp w has ids
  size_t keys;         // Key [2][16][ks]: the step's candidates, by column
  size_t list;         // Key [16][KP]: each row's best keys, descending
                       // (none here when the lists are in global memory)
  size_t buf;          // Key [16][32]: each row's buffered candidates
  size_t ring0;        // first warp's ring
  size_t ring_bytes;   // bytes per warp's ring
  size_t ring_id;      // in a ring, after uint32 [stages][32][ws]: int [stages][32]
  size_t ring_card;    //                                            int [stages][32]
  size_t total;
};

// Keys of a row's list: k rounded up to a warp's 32.
__host__ __device__ inline int list_width(int k) { return (k + 31) & ~31; }

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// chunk == 0: whole rows are staged; else `chunk` words of them at a time.
__host__ __device__ inline Layout layout(int W, int k, int warps,
                                         int stages, bool lists_global,
                                         int chunk) {
  Layout o;
  const int kp = list_width(k);
  o.ws = (chunk > 0 ? chunk : ((W + 7) & ~7)) + 4;
  o.ks = warps * kTile + 8;
  o.q_words = 0;
  o.q_id = o.q_words +
           sizeof(uint32_t) * kRows * o.ws * (chunk > 0 ? stages : 1);
  o.q_card = o.q_id + sizeof(int) * kRows;
  o.live = o.q_card + sizeof(int) * kRows;
  o.keys = align16(o.live + sizeof(int) * 2 * warps);
  o.list = o.keys + sizeof(Key) * 2 * kRows * o.ks;
  o.buf = o.list + (lists_global ? 0 : sizeof(Key) * kRows * kp);
  o.ring0 = o.buf + sizeof(Key) * kRows * kTile;
  o.ring_id = sizeof(uint32_t) * stages * kTile * o.ws;
  o.ring_card = o.ring_id + sizeof(int) * stages * kTile;
  o.ring_bytes = align16(o.ring_card + sizeof(int) * stages * kTile);
  o.total = o.ring0 + o.ring_bytes * warps;
  return o;
}

__device__ __forceinline__ void mma_b1(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The key of a present candidate: sim >= 0 maps to 0x80000000 | its bits.
// An absent candidate (PAD, self or out of range) has key 0, below all.
__device__ __forceinline__ Key make_key(int inter, int qid, int qcard,
                                        int did, int dcard, int col) {
  if (did == repro::kPadId || qid == repro::kPadId || did == qid) return 0;
  const float sim = repro::jaccard_sim(inter, qcard, dcard);
  const uint32_t hi = __float_as_uint(sim) | 0x80000000u;
  return (static_cast<Key>(hi) << 32) |
         (0xffffffffu - static_cast<uint32_t>(col));
}

// The keys of a warp's 16 x 32 intersections, in the fragments' layout
// (rows g and g + 8, columns j * 8 + 2 tig + e), into its 32 columns of
// the key tile `kt`.
__device__ __forceinline__ void write_keys(const int (&c)[4][4], Key* kt,
                                           int ks, int warp, int g, int tig,
                                           const int* sid, const int* scard,
                                           int col0, int qid_lo, int qcard_lo,
                                           int qid_hi, int qcard_hi) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int cc = j * 8 + tig * 2;
    const int2 id2 = *reinterpret_cast<const int2*>(sid + cc);
    const int2 cd2 = *reinterpret_cast<const int2*>(scard + cc);
    Key* lo_row = kt + g * ks + warp * kTile + cc;
    Key* hi_row = kt + (g + 8) * ks + warp * kTile + cc;
    *reinterpret_cast<ulonglong2*>(lo_row) = make_ulonglong2(
        make_key(c[j][0], qid_lo, qcard_lo, id2.x, cd2.x, col0 + cc),
        make_key(c[j][1], qid_lo, qcard_lo, id2.y, cd2.y, col0 + cc + 1));
    *reinterpret_cast<ulonglong2*>(hi_row) = make_ulonglong2(
        make_key(c[j][2], qid_hi, qcard_hi, id2.x, cd2.x, col0 + cc),
        make_key(c[j][3], qid_hi, qcard_hi, id2.y, cd2.y, col0 + cc + 1));
  }
}

// 16 x 32 intersections of k-steps [0, kend) on the tensor cores, added to
// c: the query rows at sq, the tile's rows at sd, both `ws` words apart.
__device__ __forceinline__ void intersect(int (&c)[4][4], const uint32_t* sq,
                                          const uint32_t* sd, int ws,
                                          int kend, int g, int tig) {
  for (int kk = 0; kk < kend; kk += 8) {
    const uint32_t a0 = sq[g * ws + kk + tig];
    const uint32_t a1 = sq[(g + 8) * ws + kk + tig];
    const uint32_t a2 = sq[g * ws + kk + tig + 4];
    const uint32_t a3 = sq[(g + 8) * ws + kk + tig + 4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t* d = sd + (j * 8 + g) * ws + kk + tig;
      mma_b1(c[j], a0, a1, a2, a3, d[0], d[4]);
    }
  }
}

// The k-th key of list i of x.
template <int L, int R>
__device__ __forceinline__ Key kth(const Key (&x)[R * L], int i, int k) {
  return __shfl_sync(kFull, (L == 2 && k > 32) ? x[i * L + L - 1] : x[i * L],
                     (k - 1) & 31);
}

// Merge one row's buffer (cnt keys, in any order) into its list of kp
// keys in memory (descending, zeros after its keys; at most k kept) and
// return the list's k-th key, 0 while it holds fewer. Every key present is
// distinct, so each one's place in the merged list is its rank in its own
// list plus the keys of the other above it: the buffer is sorted across
// the lanes and each of its keys finds its place by a binary search of the
// list; then the list's keys move up by the buffered keys above them, the
// last 32 first, so that none is overwritten before it is read.
__device__ __forceinline__ Key flush_row_mem(Key* list, Key* buf, int cnt,
                                             int k, int lane) {
  __syncwarp();
  Key b[1] = {lane < cnt ? buf[lane] : 0};
  sort_asc<1>(b, lane);  // the cnt keys in lanes 32 - cnt .. 31
  const int j = 31 - lane;  // b's place in the buffer, descending
  int len = 0, hi = k;  // the list's keys: the nonzero prefix
  while (len < hi) {
    const int mid = (len + hi) >> 1;
    if (list[mid] != 0) len = mid + 1; else hi = mid;
  }
  int at = k;
  if (j < cnt) {
    int lo = 0;
    hi = len;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (list[mid] > b[0]) lo = mid + 1; else hi = mid;
    }
    at = j + lo;
  }
  __syncwarp();
  buf[j] = b[0];
  __syncwarp();
  for (int c0 = len > 0 ? (len - 1) & ~31 : -32; c0 >= 0; c0 -= 32) {
    const int i = c0 + lane;
    const Key x = i < len ? list[i] : 0;
    int lo = 0;
    hi = cnt;  // buffered keys above x
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (buf[mid] > x) lo = mid + 1; else hi = mid;
    }
    __syncwarp();
    if (i < len && i + lo < k) list[i + lo] = x;
    __syncwarp();
  }
  if (at < k) list[at] = b[0];
  __syncwarp();
  return list[k - 1];
}

// Merge the buffers of R rows (cnt[i] keys each) into their lists (list
// i's element j * 32 + lane in x[i * L + j], descending; for L = 0 the
// lists stay in memory, flush_row_mem); the rows' new k-th keys go to thr.
template <int L, int R>
__device__ __forceinline__ void flush_rows(Key* list, Key* buf,
                                           const int (&row)[R],
                                           const int (&cnt)[R], int k,
                                           int lane, Key (&thr)[R]) {
  if constexpr (L == 0) {
    const int kp = list_width(k);
#pragma unroll
    for (int i = 0; i < R; ++i)
      thr[i] = flush_row_mem(list + static_cast<size_t>(row[i]) * kp,
                             buf + row[i] * kTile, cnt[i], k, lane);
  } else {
    constexpr int KP = 32 * L;
    __syncwarp();
    Key x[R * L], b[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < L; ++j) x[i * L + j] = list[row[i] * KP + j * 32 + lane];
      b[i] = lane < cnt[i] ? buf[row[i] * kTile + lane] : 0;
    }
    sort_asc<R>(b, lane);
    // Half-cleaner of each list against its buffer reversed (ascending, with
    // zeros below it when L = 2): the top 32 L of both, bitonic; then a
    // bitonic merge sorts them.
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (L == 1) {
        x[i] = kmax(x[i], b[i]);
      } else {
        const Key m1 = kmax(x[2 * i + 1], b[i]);
        x[2 * i + 1] = kmin(x[2 * i], m1);
        x[2 * i] = kmax(x[2 * i], m1);
      }
    }
    bitonic_desc<R * L>(x, lane);
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < L; ++j) list[row[i] * KP + j * 32 + lane] = x[i * L + j];
      thr[i] = kth<L, R>(x, i, k);
    }
    __syncwarp();
  }
}

template <int L, int NW, bool WIDE>
__global__ void __launch_bounds__(NW * 32)
goldfinger_knn_kernel(const uint32_t* __restrict__ q_words,
                      const int* __restrict__ q_card,
                      const int* __restrict__ q_ids,
                      const uint32_t* __restrict__ d_words,
                      const int* __restrict__ d_card,
                      const int* __restrict__ d_ids,
                      int* __restrict__ out_ids, float* __restrict__ out_sims,
                      int nq, int nd, int W, int k, int stages, int vec16,
                      Key* __restrict__ g_lists, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int KP = L ? 32 * L : list_width(k);
  constexpr int R = kRows / NW;     // rows whose top-k this warp keeps
  constexpr int G = R < 4 ? R : 4;  // rows flushed together
  const Layout lo =
      layout(W, k, NW, stages, L == 0 && g_lists != nullptr, WIDE ? chunk : 0);
  const int ws = lo.ws, ks = lo.ks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const long long qbase = static_cast<long long>(blockIdx.y) * nq;
  const long long dbase = static_cast<long long>(blockIdx.y) * nd;
  const int row0 = blockIdx.x * kRows;

  uint32_t* sq = reinterpret_cast<uint32_t*>(smem + lo.q_words);
  int* s_qid = reinterpret_cast<int*>(smem + lo.q_id);
  int* s_qcard = reinterpret_cast<int*>(smem + lo.q_card);
  int* s_live = reinterpret_cast<int*>(smem + lo.live);
  Key* keys = reinterpret_cast<Key*>(smem + lo.keys);
  // The lists of L = 0 are in global memory when g_lists is given: the
  // block's 16 rows of KP keys.
  Key* list = L == 0 && g_lists != nullptr
                  ? g_lists + (static_cast<size_t>(blockIdx.y) * gridDim.x +
                               blockIdx.x) * kRows * KP
                  : reinterpret_cast<Key*>(smem + lo.list);
  Key* buf = reinterpret_cast<Key*>(smem + lo.buf);
  unsigned char* mine = smem + lo.ring0 + lo.ring_bytes * warp;
  uint32_t* ring = reinterpret_cast<uint32_t*>(mine);
  int* ring_id = reinterpret_cast<int*>(mine + lo.ring_id);
  int* ring_card = reinterpret_cast<int*>(mine + lo.ring_card);

  int live = 0;
  if (tid < kRows) {
    const int row = row0 + tid;
    const int id = row < nq ? q_ids[qbase + row] : repro::kPadId;
    s_qid[tid] = id;
    s_qcard[tid] = row < nq ? q_card[qbase + row] : 0;
    live = id != repro::kPadId;
  }
  if (!__syncthreads_or(live)) {
    for (int i = tid; i < kRows * k; i += blockDim.x) {
      const int row = row0 + i / k;
      if (row >= nq) continue;
      out_ids[(qbase + row) * k + i % k] = repro::kPadId;
      out_sims[(qbase + row) * k + i % k] = repro::neg_inf();
    }
    return;
  }
  // The query tile by cp.async; its padding words and missing rows are 0.
  // (WIDE: its chunks are copied with the database tiles' below.)
  const int nrows = min(kRows, nq - row0);
  const int step = vec16 ? 4 : 1;
  if constexpr (!WIDE) {
    for (int i = tid * step; i < kRows * ws; i += blockDim.x * step) {
      const int r = i / ws, w = i - r * ws;
      uint32_t* dst = sq + i;
      const uint32_t* src = q_words + (qbase + row0 + r) * W + w;
      if (r >= nrows || w >= W) {
        for (int e = 0; e < step; ++e) dst[e] = 0u;
      } else if (vec16) {
        repro::cp_async_16(dst, src);
      } else {
        repro::cp_async_4(dst, src);
      }
    }
    repro::cp_async_commit();
  }
  for (int i = tid; i < kRows * KP; i += blockDim.x) list[i] = 0;

  // Copy database tile t (words, ids, cards) into ring slot `slot`.
  auto issue = [&](int t, int slot) {
    const int col0 = t * kTile;
    const int rows = min(kTile, nd - col0);
    uint32_t* dst = ring + slot * kTile * ws;
    if (lane < rows) {
      repro::cp_async_4(ring_id + slot * kTile + lane, d_ids + dbase + col0 + lane);
      repro::cp_async_4(ring_card + slot * kTile + lane,
                        d_card + dbase + col0 + lane);
    } else {
      ring_id[slot * kTile + lane] = repro::kPadId;
    }
    const uint32_t* src = d_words + (dbase + col0) * W;
    if (vec16) {
      const int per = W >> 2;
      for (int i = lane; i < rows * per; i += 32) {
        const int r = i / per, c = (i - r * per) << 2;
        repro::cp_async_16(dst + r * ws + c, src + static_cast<long long>(r) * W + c);
      }
    } else {
      for (int i = lane; i < rows * W; i += 32) {
        const int r = i / W, c = i - r * W;
        repro::cp_async_4(dst + r * ws + c, src + static_cast<long long>(r) * W + c);
      }
    }
  };
  // WIDE: the same for words [w0, w0 + wn) of the rows. The whole-row
  // instances keep their own copy of the tile copy, the intersections and
  // the keys: routed through the chunked path's helpers they compiled to
  // more instructions and a slower main-path sweep (PERF.md §6).
  auto issue_words = [&](int t, int slot, int w0, int wn) {
    const int col0 = t * kTile;
    const int rows = min(kTile, nd - col0);
    uint32_t* dst = ring + slot * kTile * ws;
    if (lane < rows) {
      repro::cp_async_4(ring_id + slot * kTile + lane, d_ids + dbase + col0 + lane);
      repro::cp_async_4(ring_card + slot * kTile + lane,
                        d_card + dbase + col0 + lane);
    } else {
      ring_id[slot * kTile + lane] = repro::kPadId;
    }
    const uint32_t* src = d_words + (dbase + col0) * W + w0;
    if (vec16) {
      const int per = wn >> 2;
      for (int i = lane; i < rows * per; i += 32) {
        const int r = i / per, c = (i - r * per) << 2;
        repro::cp_async_16(dst + r * ws + c, src + static_cast<long long>(r) * W + c);
      }
    } else {
      for (int i = lane; i < rows * wn; i += 32) {
        const int r = i / wn, c = i - r * wn;
        repro::cp_async_4(dst + r * ws + c, src + static_cast<long long>(r) * W + c);
      }
    }
  };

  // Step s: warp w computes the keys of database tile s * NW + w, then
  // every warp filters the step's NW tiles into its R rows (rows warp,
  // warp + NW, ...). Warp w's next tiles are copied `stages` - 1 steps ahead.
  const int ntiles = (nd + kTile - 1) / kTile;
  const int nsteps = (ntiles + NW - 1) / NW;
  // WIDE: item e = s * nch + ch is chunk ch of step s: the query rows'
  // words [ch * chunk, + chunk), copied by the whole block, and those of
  // warp w's tile of step s, copied by warp w, into slot e % stages.
  const int nch = WIDE ? (W + chunk - 1) / chunk : 1;
  const int nitems = nsteps * nch;
  auto issue_chunk = [&](int item) {
    const int s = item / nch, ch = item - s * nch, slot = item % stages;
    const int w0 = ch * chunk, wn = min(chunk, W - w0);
    uint32_t* dq = sq + slot * kRows * ws;
    for (int i = tid * step; i < kRows * chunk; i += blockDim.x * step) {
      const int r = i / chunk, w = i - r * chunk;
      uint32_t* dst = dq + r * ws + w;
      const uint32_t* src = q_words + (qbase + row0 + r) * W + w0 + w;
      if (r >= nrows || w >= wn) {
        for (int e = 0; e < step; ++e) dst[e] = 0u;
      } else if (vec16) {
        repro::cp_async_16(dst, src);
      } else {
        repro::cp_async_4(dst, src);
      }
    }
    const int t = warp + s * NW;
    if (t < ntiles) issue_words(t, slot, w0, wn);
  };
  if constexpr (WIDE) {
    for (int p = 0; p + 1 < stages; ++p) {
      if (p < nitems) issue_chunk(p);
      repro::cp_async_commit();
    }
  } else {
    for (int p = 0; p + 1 < stages; ++p) {
      if (warp + p * NW < ntiles) issue(warp + p * NW, p);
      repro::cp_async_commit();
    }
    repro::cp_async_wait<0>();  // the query tile (and the first tiles)
    __syncthreads();
  }

  const int qid_lo = s_qid[g], qid_hi = s_qid[g + 8];
  const int qcard_lo = s_qcard[g], qcard_hi = s_qcard[g + 8];
  const unsigned lower = (1u << lane) - 1u;
  Key thr[R];  // per own row, warp-uniform: the list's k-th key
  int cnt[R];  //                             keys in the buffer
#pragma unroll
  for (int i = 0; i < R; ++i) {
    thr[i] = 0;
    cnt[i] = 0;
  }
  for (int s = 0; s < nsteps; ++s) {
    Key* kt = keys + (s & 1) * kRows * ks;
    bool has;
    if constexpr (WIDE) {
      const int t = warp + s * NW;
      int c[4][4] = {};
      int slot = 0;
      has = false;
      for (int ch = 0; ch < nch; ++ch) {
        const int item = s * nch + ch;
        __syncthreads();  // every warp is done with the slot refilled here
        if (item + stages - 1 < nitems) issue_chunk(item + stages - 1);
        repro::cp_async_commit();
        if (stages == 1) {
          repro::cp_async_wait<0>();
        } else {
          repro::cp_async_wait<1>();
        }
        __syncthreads();  // item's query chunk, copied by every thread
        slot = item % stages;
        // A tile past the end or whose ids are all PAD is skipped.
        has = t < ntiles &&
              __ballot_sync(kFull, ring_id[slot * kTile + lane] !=
                                       repro::kPadId) != 0;
        if (has) {
          const int wn = min(chunk, W - ch * chunk);
          intersect(c, sq + slot * kRows * ws, ring + slot * kTile * ws, ws,
                    (wn + 7) & ~7, g, tig);
        }
      }
      if (has)
        write_keys(c, kt, ks, warp, g, tig, ring_id + slot * kTile,
                   ring_card + slot * kTile, t * kTile, qid_lo, qcard_lo,
                   qid_hi, qcard_hi);
    } else {
      const int ahead = warp + (s + stages - 1) * NW;
      if (ahead < ntiles) issue(ahead, (s + stages - 1) % stages);
      repro::cp_async_commit();
      if (stages == 1) {
        repro::cp_async_wait<0>();
      } else {
        repro::cp_async_wait<1>();
      }
      __syncwarp();
      const int t = warp + s * NW;
      const int slot = s % stages;
      const int* sid = ring_id + slot * kTile;
      // A tile past the end or whose ids are all PAD is skipped.
      has = t < ntiles &&
            __ballot_sync(kFull, sid[lane] != repro::kPadId) != 0;
      if (has) {
        const uint32_t* sd = ring + slot * kTile * ws;
        const int* scard = ring_card + slot * kTile;
        const int col0 = t * kTile;
        // 16 x 32 intersections on the tensor cores.
        int c[4][4] = {};
        for (int kk = 0; kk < ws - 4; kk += 8) {
          const uint32_t a0 = sq[g * ws + kk + tig];
          const uint32_t a1 = sq[(g + 8) * ws + kk + tig];
          const uint32_t a2 = sq[g * ws + kk + tig + 4];
          const uint32_t a3 = sq[(g + 8) * ws + kk + tig + 4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t* d = sd + (j * 8 + g) * ws + kk + tig;
            mma_b1(c[j], a0, a1, a2, a3, d[0], d[4]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cc = j * 8 + tig * 2;
          const int2 id2 = *reinterpret_cast<const int2*>(sid + cc);
          const int2 cd2 = *reinterpret_cast<const int2*>(scard + cc);
          Key* lo_row = kt + g * ks + warp * kTile + cc;
          Key* hi_row = kt + (g + 8) * ks + warp * kTile + cc;
          *reinterpret_cast<ulonglong2*>(lo_row) = make_ulonglong2(
              make_key(c[j][0], qid_lo, qcard_lo, id2.x, cd2.x, col0 + cc),
              make_key(c[j][1], qid_lo, qcard_lo, id2.y, cd2.y, col0 + cc + 1));
          *reinterpret_cast<ulonglong2*>(hi_row) = make_ulonglong2(
              make_key(c[j][2], qid_hi, qcard_hi, id2.x, cd2.x, col0 + cc),
              make_key(c[j][3], qid_hi, qcard_hi, id2.y, cd2.y, col0 + cc + 1));
        }
      }
    }
    if (lane == 0) s_live[(s & 1) * NW + warp] = has;
    __syncwarp();  // this warp's ring slot is free again
    __syncthreads();

    // Row warp + i * NW's candidates in the column block of warp v are
    // lane l's key[i] (column (s * NW + v) * 32 + l). Filter the R rows
    // against their current k-th keys, then buffer the survivors; when a
    // buffer of a group of rows would overflow, the group's buffers are
    // merged into their lists first.
    for (int v = 0; v < NW; ++v) {
      if (!s_live[(s & 1) * NW + v]) continue;
      Key key[R];
      unsigned surv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        key[i] = kt[(warp + i * NW) * ks + v * kTile + lane];
        surv[i] = __ballot_sync(kFull, key[i] > thr[i]);
      }
#pragma unroll
      for (int q = 0; q < R; q += G) {
        bool full = false;
#pragma unroll
        for (int i = q; i < q + G; ++i) full |= cnt[i] + __popc(surv[i]) > kTile;
        if (full) {
          int row[G], n[G];
          Key t2[G];
#pragma unroll
          for (int i = 0; i < G; ++i) {
            row[i] = warp + (q + i) * NW;
            n[i] = cnt[q + i];
          }
          flush_rows<L, G>(list, buf, row, n, k, lane, t2);
#pragma unroll
          for (int i = 0; i < G; ++i) {
            thr[q + i] = t2[i];
            cnt[q + i] = 0;
            surv[q + i] = __ballot_sync(kFull, key[q + i] > t2[i]);
          }
        }
#pragma unroll
        for (int i = q; i < q + G; ++i) {
          const int r = warp + i * NW;
          if (key[i] > thr[i])
            buf[r * kTile + cnt[i] + __popc(surv[i] & lower)] = key[i];
          cnt[i] += __popc(surv[i]);
        }
      }
    }
  }
  repro::cp_async_wait<0>();

  // Flush the own rows' buffers and write the rows out.
#pragma unroll
  for (int q = 0; q < R; q += G) {
    int row[G], n[G];
    Key t2[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      row[i] = warp + (q + i) * NW;
      n[i] = cnt[q + i];
    }
    flush_rows<L, G>(list, buf, row, n, k, lane, t2);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int row_out = row0 + row[i];
      if (row_out >= nq) continue;
      for (int e = lane; e < k; e += 32) {
        const long long o = (qbase + row_out) * k + e;
        const Key key = list[row[i] * KP + e];
        if (key == 0) {
          out_ids[o] = repro::kPadId;
          out_sims[o] = repro::neg_inf();
        } else {
          const uint32_t hi = static_cast<uint32_t>(key >> 32);
          const int col = static_cast<int>(0xffffffffu - static_cast<uint32_t>(key));
          out_sims[o] = __uint_as_float(hi & 0x7fffffffu);
          out_ids[o] = d_ids[dbase + col];
        }
      }
    }
  }
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// Dynamic shared memory of one block (kernels/goldfinger_knn/ops.py
// smem_bytes computes the same total; the wrapper checks that they agree).
// lists_global != 0: the rows' lists (k > 64 only) are in global memory;
// chunk > 0: rows stream through in chunks of that many words.
REPRO_EXPORT size_t repro_goldfinger_knn_smem_bytes(int W, int k, int warps,
                                                    int stages,
                                                    int lists_global,
                                                    int chunk) {
  return layout(W, k, warps, stages, lists_global != 0, chunk).total;
}

// q_* are [batches, nq, ...] and d_* are [batches, nd, ...], row-major and
// contiguous (words as uint32 bit patterns); outputs are [batches, nq, k].
// `warps` warps per block (1, 2, 4 or 8), a `stages`-deep cp.async ring
// per warp (1 or 2); vec16 != 0 allows 16-byte copies (W % 4 == 0, q_words
// and d_words 16-byte aligned). chunk: 0 stages whole rows; a positive
// multiple of 8 streams them in chunks of that many words (the WIDE
// instances). k >= 1: up to 64, each row's list lives in
// its warp's registers while it merges (one or two keys a lane); above 64
// it is merged in memory, in shared memory or, given `lists` (a workspace
// of 16 * ((k + 31) & ~31) keys for each of the ceil(nq / 16) * batches
// blocks), in global memory. batches <= 65535 (the grid's y). Launches on
// `stream` and returns cudaGetLastError().
REPRO_EXPORT int repro_goldfinger_knn(const void* q_words, const void* q_card,
                                      const void* q_ids, const void* d_words,
                                      const void* d_card, const void* d_ids,
                                      void* out_ids, void* out_sims,
                                      int batches, int nq, int nd, int W,
                                      int k, int warps, int stages, int vec16,
                                      int chunk, void* lists, void* stream) {
  if (stages < 1 || stages > 2 || k < 1 || batches > 65535 ||
      (lists != nullptr && k <= 64) || chunk < 0 || chunk % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // One instance per (whole or chunked rows, list kind, warps); the
  // largest dynamic shared memory each was allowed so far, per device.
  static void (*const kernels[2][3][4])(
      const uint32_t*, const int*, const int*, const uint32_t*, const int*,
      const int*, int*, float*, int, int, int, int, int, int, Key*, int) = {
      {{goldfinger_knn_kernel<1, 1, false>, goldfinger_knn_kernel<1, 2, false>,
        goldfinger_knn_kernel<1, 4, false>, goldfinger_knn_kernel<1, 8, false>},
       {goldfinger_knn_kernel<2, 1, false>, goldfinger_knn_kernel<2, 2, false>,
        goldfinger_knn_kernel<2, 4, false>, goldfinger_knn_kernel<2, 8, false>},
       {goldfinger_knn_kernel<0, 1, false>, goldfinger_knn_kernel<0, 2, false>,
        goldfinger_knn_kernel<0, 4, false>, goldfinger_knn_kernel<0, 8, false>}},
      {{goldfinger_knn_kernel<1, 1, true>, goldfinger_knn_kernel<1, 2, true>,
        goldfinger_knn_kernel<1, 4, true>, goldfinger_knn_kernel<1, 8, true>},
       {goldfinger_knn_kernel<2, 1, true>, goldfinger_knn_kernel<2, 2, true>,
        goldfinger_knn_kernel<2, 4, true>, goldfinger_knn_kernel<2, 8, true>},
       {goldfinger_knn_kernel<0, 1, true>, goldfinger_knn_kernel<0, 2, true>,
        goldfinger_knn_kernel<0, 4, true>, goldfinger_knn_kernel<0, 8, true>}}};
  // cudaFuncSetAttribute acts on the current device only, so the opt-in
  // is remembered per device (devices past kMaxDevices opt in every call).
  constexpr int kMaxDevices = 64;
  static size_t allowed[kMaxDevices][2][3][4] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) device = kMaxDevices;
  int wi;
  switch (warps) {
    case 1: wi = 0; break;
    case 2: wi = 1; break;
    case 4: wi = 2; break;
    case 8: wi = 3; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ci = chunk > 0 ? 1 : 0;
  const int li = k <= 32 ? 0 : k <= 64 ? 1 : 2;
  const size_t smem =
      layout(W, k, warps, stages, lists != nullptr, chunk).total;
  size_t* seen = device < kMaxDevices ? &allowed[device][ci][li][wi]
                                       : nullptr;
  if (smem > 48 * 1024 && (seen == nullptr || smem > *seen)) {
    cudaError_t e = cudaFuncSetAttribute(
        kernels[ci][li][wi], cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (seen != nullptr) *seen = smem;
  }
  const dim3 grid((nq + kRows - 1) / kRows, batches);
  kernels[ci][li][wi]<<<grid, warps * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q_words), static_cast<const int*>(q_card),
      static_cast<const int*>(q_ids), static_cast<const uint32_t*>(d_words),
      static_cast<const int*>(d_card), static_cast<const int*>(d_ids),
      static_cast<int*>(out_ids), static_cast<float*>(out_sims), nq, nd, W, k,
      stages, vec16, static_cast<Key*>(lists), chunk);
  return static_cast<int>(cudaGetLastError());
}
