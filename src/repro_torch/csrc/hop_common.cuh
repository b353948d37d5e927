// The descent hop's lanes, suppression and selection, shared by the two
// hop kernels (descent_hop.cu: fingerprint rows read straight from global
// memory; descent_hop_dma.cu: rows gathered by bulk copies into a
// shared-memory ring). Everything here decides ids and ranks, never how a
// fingerprint row reaches the scorer, so the two kernels agree bit for bit.
//
// Lanes are [beam | fwd | rev] in the reference's column order: B beam
// lanes, then the C = B * (kg + kr) candidate lanes (forward neighbours of
// every beam lane, then reverse ones). A block of kThreads threads works on
// one query at a time, in five steps, each ending at a block barrier:
//   1. stage_beam: the beam in shared memory, lanes naming tombstoned rows
//      turned to PAD / -inf; the query's words; an empty hash table;
//   2. gather_lanes: every lane's id (candidates: the beam lane's adjacency
//      row, PAD under a PAD beam lane), each non-PAD id inserted into the
//      table with its column -- open addressing; a slot keeps its id's
//      lowest column (atomicMin) and counts its candidate lanes;
//   3. classify_slots: a scan of the table, not of the lanes. An id whose
//      lowest column is a beam lane is in the beam: its candidate lanes are
//      suppressed. Any other id is a candidate's; its lowest column is its
//      "owner" lane, which alone is scored (the rows of duplicate lanes are
//      never read), unless the id is tombstoned: then all its lanes are
//      PAD, as in the reference. n_scored sums the live owners' lane
//      counts. Owners go to a work list with their ids and card words;
//   4. (the kernel's own) score each owner; the keys of the B beam lanes
//      and of the owners, in that order, overwrite the hash table;
//   5. select_beam: the top B of those B + n_work keys: the warps' lists
//      of 32 P keys (P a power of 2 up to 16, so B <= kMaxBeam), or for a
//      wider beam (P = 0) a radix select of the B-th key over the block.
// Where the state lives. A query's state (Layout below) sits in the
// block's shared memory where it fits (kGlobal false); a wider one is
// carved from a per-block workspace in global memory that the wrapper
// allocates (kGlobal true), one block per resident slot walking its
// queries in turn. The table's atomics and the barriers work the same on
// either; the DMA hop's ring stays in shared memory.
// Why step 3 keeps the selection exact: all lanes that name one id carry
// the same sim (same row, same query, same epilogue), beam ids do not
// repeat, and a candidate naming a beam id is suppressed; so keeping each
// id's lowest column and taking the plain top-B of the keys (sim desc,
// column asc) is exactly select_topk(..., dedup_ids=True) -- and
// merge_topk, which keeps each id's first column.
#pragma once

#include "keys.cuh"

namespace repro {
namespace hop {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBuffers = 4;  // the DMA hop's deepest ring
constexpr int kMaxBeam = 512;   // 32 * 16: the warps' lists of 16 keys a lane
constexpr Key kTopKey = ~0ull;  // above every key: a min's identity

// Keys per lane of a list that holds the top B: a power of 2, 1 to 16;
// 0 for a beam wider than kMaxBeam (select_beam's radix select).
__host__ __device__ inline int list_regs(int B) {
  if (B > kMaxBeam) return 0;
  int p = 1;
  while (32 * p < B) p <<= 1;
  return p;
}

// Keys of the state's `list`: the warps' lists, or the B selected keys of
// the radix select.
__host__ __device__ inline size_t list_keys(int B) {
  const int p = list_regs(B);
  return p ? static_cast<size_t>(kWarps) * 32 * p : static_cast<size_t>(B);
}

// Hash slots for L lanes: 1.5 L + 1 (load at most 2/3, one slot always
// free), and at least L, so the keys can take the table's place.
__host__ __device__ inline int hash_slots(int L) { return L + L / 2 + 1; }

__host__ __device__ inline size_t align_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

// Byte offsets of one query's state and of a block's dynamic shared
// memory. `ring_rows` rows of W words and 2 * kMaxBuffers mbarriers come
// first in shared memory for the DMA hop (0 for the fused hop); the state
// follows them there, or (global_state) starts at 0 in the block's
// workspace and shared memory holds the ring alone.
struct Layout {
  int slots;
  size_t ring;   // uint32 [ring_rows][W]
  size_t bars;   // uint64 [2][kMaxBuffers]: full, empty
  size_t tab;    // int [3][slots]: id (PAD if free), lowest column,
                 // candidate lanes; after step 3 the keys: Key [B + n_work]
  size_t list;   // Key [list_keys(B)]: each warp's top keys, or the
                 // selected keys of the radix select
  size_t buf;    // Key [kWarps][32]: each warp's buffered keys, or the
                 // radix select's histogram
  size_t qw;     // uint32 [W rounded up to 4], 16-byte aligned
  size_t id;     // int [L]
  size_t bsim;   // float [B]
  size_t work;   // int [C]: owner lanes' columns
  size_t wid;    // int [C]: their ids
  size_t wcard;  // int [C]: their rows' card words
  size_t misc;   // Key thr0; int n_work, n_scored
  size_t total;  // the state's end
  size_t smem;   // the block's dynamic shared memory
};

__host__ __device__ inline Layout layout(int W, int kg, int kr, int B,
                                         int ring_rows, bool global_state) {
  const size_t C = static_cast<size_t>(B) * (kg + kr);
  const size_t L = B + C;
  Layout o;
  o.slots = hash_slots(static_cast<int>(L));
  o.ring = 0;
  o.bars = align_up(static_cast<size_t>(ring_rows) * W * 4, 16);
  const size_t head = o.bars + (ring_rows > 0 ? 2 * kMaxBuffers * 8 : 0);
  o.tab = global_state ? 0 : head;
  o.list = o.tab + align_up(static_cast<size_t>(o.slots) * 12, 8);
  o.buf = o.list + list_keys(B) * 8;
  o.qw = align_up(o.buf + static_cast<size_t>(kWarps) * 32 * 8, 16);
  o.id = o.qw + align_up(static_cast<size_t>(W), 4) * 4;
  o.bsim = o.id + L * 4;
  o.work = o.bsim + static_cast<size_t>(B) * 4;
  o.wid = o.work + C * 4;
  o.wcard = o.wid + C * 4;
  o.misc = align_up(o.wcard + C * 4, 8);
  o.total = o.misc + 16;
  o.smem = global_state ? head : o.total;
  return o;
}

// Bytes of one block's workspace in global memory: the state, rounded up
// so that every block's starts 256-byte aligned.
__host__ __device__ inline size_t workspace_stride(int W, int kg, int kr,
                                                   int B) {
  return align_up(layout(W, kg, kr, B, 0, true).total, 256);
}

// The shard axis. A sharded launch stacks the S shards' tables ([S, cap]
// rows) and beams and outputs ([S, q] rows) and runs shard s in the blocks
// of grid row blockIdx.y = s; the queries' words and cards are every
// shard's. A single-placement launch is S = 1: grid row 0, no offset.
// `p` advanced to this block's shard, whose rows start `rows` rows of
// `width` elements in.
template <class T>
__device__ __forceinline__ T* shard_rows(T* p, long long rows, int width) {
  return p + static_cast<long long>(blockIdx.y) * rows * width;
}

// This block's slice of a workspace of `stride`-byte slices, one per block
// of the (x, y) grid.
__device__ __forceinline__ unsigned char* block_workspace(unsigned char* ws,
                                                          size_t stride) {
  return ws + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                  stride;
}

// Pointers into one query's state.
struct State {
  int slots;
  int* tab_id;
  int* tab_col;
  int* tab_cnt;
  Key* key;
  Key* list;
  Key* buf;
  uint32_t* qw;
  int* id;
  float* bsim;
  int* work;
  int* wid;
  int* wcard;
  Key* thr0;  // the beam's lowest key: no key below it can be selected
  int* n_work;
  int* n_scored;
};

// The state at `smem`: the block's shared memory, or (global_state) the
// block's workspace.
__device__ inline State carve(unsigned char* smem, const Layout& lo) {
  State s;
  s.slots = lo.slots;
  s.tab_id = reinterpret_cast<int*>(smem + lo.tab);
  s.tab_col = s.tab_id + lo.slots;
  s.tab_cnt = s.tab_col + lo.slots;
  s.key = reinterpret_cast<Key*>(smem + lo.tab);
  s.list = reinterpret_cast<Key*>(smem + lo.list);
  s.buf = reinterpret_cast<Key*>(smem + lo.buf);
  s.qw = reinterpret_cast<uint32_t*>(smem + lo.qw);
  s.id = reinterpret_cast<int*>(smem + lo.id);
  s.bsim = reinterpret_cast<float*>(smem + lo.bsim);
  s.work = reinterpret_cast<int*>(smem + lo.work);
  s.wid = reinterpret_cast<int*>(smem + lo.wid);
  s.wcard = reinterpret_cast<int*>(smem + lo.wcard);
  s.thr0 = reinterpret_cast<Key*>(smem + lo.misc);
  s.n_work = reinterpret_cast<int*>(smem + lo.misc + 8);
  s.n_scored = s.n_work + 1;
  return s;
}

// Threads per fingerprint row when a row is read in `chunks` pieces (16
// bytes each when W % 4 == 0 and the table is 16-byte aligned, else 4): a
// power of 2 up to a warp, so a warp's load instruction covers 32 / G
// whole rows and a __shfl_xor over G lanes sums a row's intersection.
__device__ __forceinline__ int row_group(int chunks) {
  int g = 1;
  while (g < chunks && g < 32) g <<= 1;
  return g;
}

// Fibonacci hashing, mapped onto [0, slots) by a 32 x 32 -> 64 product.
__device__ __forceinline__ int hash_of(int id, int slots) {
  const uint32_t h = static_cast<uint32_t>(id) * 2654435769u;
  return static_cast<int>((static_cast<unsigned long long>(h) *
                           static_cast<uint32_t>(slots)) >> 32);
}

__device__ __forceinline__ int next_slot(int h, int slots) {
  return h + 1 == slots ? 0 : h + 1;
}

// Insert `id` at column `col`: claim or find its slot (linear probing),
// lower its lowest column, count a candidate lane. A stale read of the
// column only skips an atomicMin that could not lower it.
__device__ __forceinline__ void table_insert(const State& s, int id,
                                             int col, bool candidate) {
  int h = hash_of(id, s.slots);
  for (;;) {
    const int old = atomicCAS(&s.tab_id[h], kPadId, id);
    if (old == kPadId || old == id) break;
    h = next_slot(h, s.slots);
  }
  if (col < s.tab_col[h]) atomicMin(&s.tab_col[h], col);
  if (candidate) atomicAdd(&s.tab_cnt[h], 1);
}

// Step 1. Every thread of the block must call it; a barrier must follow.
__device__ inline void stage_beam(const int* beam_ids, const float* beam_sims,
                                  const uint8_t* __restrict__ tomb,
                                  const uint32_t* q_words, int W, int B,
                                  const State& s) {
  const int tid = threadIdx.x;
  for (int i = tid; i < s.slots; i += kThreads) {
    s.tab_id[i] = kPadId;
    s.tab_col[i] = 0x7fffffff;
    s.tab_cnt[i] = 0;
  }
  for (int b = tid; b < B; b += kThreads) {
    int id = beam_ids[b];
    float sim = beam_sims[b];
    if (id != kPadId && tomb[id]) {
      id = kPadId;
      sim = neg_inf();
    }
    s.id[b] = id;
    s.bsim[b] = sim;
  }
  for (int w = tid; w < static_cast<int>(align_up(W, 4)); w += kThreads)
    s.qw[w] = w < W ? q_words[w] : 0u;
  if (tid == 0) {
    *s.n_work = 0;
    *s.n_scored = 0;
  }
}

// Step 2: each thread takes up to kPer lanes at once, so their adjacency
// loads are in flight together.
__device__ inline void gather_lanes(const int* __restrict__ graph,
                                    const int* __restrict__ rev, int kg,
                                    int kr, int B, const State& s) {
  constexpr int kPer = 4;
  const int n_fwd = B * kg;
  const int L = B + B * (kg + kr);
  for (int l0 = threadIdx.x; l0 < L; l0 += kThreads * kPer) {
    int ids[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int l = l0 + u * kThreads;
      int id = kPadId;
      if (l < B) {
        id = s.id[l];
      } else if (l < L) {
        const int c = l - B;
        const bool fwd = c < n_fwd;
        const int k = fwd ? kg : kr;
        const int cc = fwd ? c : c - n_fwd;
        const int b = cc / k;
        const int bid = s.id[b];
        if (bid != kPadId)
          id = __ldg((fwd ? graph : rev) + static_cast<long long>(bid) * k +
                     (cc - b * k));
      }
      ids[u] = id;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int l = l0 + u * kThreads;
      if (l >= B && l < L) s.id[l] = ids[u];
      if (ids[u] != kPadId) table_insert(s, ids[u], l, l >= B);
    }
  }
}

// A beam lane's key: 0 for a PAD or -inf lane.
__device__ __forceinline__ Key beam_key(const State& s, int b) {
  return s.id[b] == kPadId ? 0 : sim_key(s.bsim[b], b);
}

// Step 3, plus thr0: each thread scans kPer slots at once, so the owners'
// tombstone and card loads are in flight together. Work-list order depends
// on the schedule; nothing downstream depends on that order.
__device__ inline void classify_slots(const int* __restrict__ card,
                                      const uint8_t* __restrict__ tomb,
                                      int B, const State& s) {
  constexpr int kPer = 6;  // one pass over the main path's 2,929 slots
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int scored = 0;
  for (int h0 = warp * 32; h0 < s.slots; h0 += kThreads * kPer) {
    int id[kPer], col[kPer], cd[kPer];
    bool own[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int h = h0 + u * kThreads + lane;
      id[u] = h < s.slots ? s.tab_id[h] : kPadId;
      col[u] = id[u] != kPadId ? s.tab_col[h] : 0;
      own[u] = id[u] != kPadId && col[u] >= B;
      bool dead = false;
      cd[u] = 0;
      if (own[u]) {  // both loads in flight at once
        dead = __ldg(tomb + id[u]);
        cd[u] = __ldg(card + id[u]);
      }
      own[u] = own[u] && !dead;
    }
    // One atomicAdd per warp reserves the work-list entries of all kPer.
    unsigned m[kPer];
    int total = 0;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      m[u] = __ballot_sync(kFullMask, own[u]);
      total += __popc(m[u]);
    }
    int at = 0;
    if (lane == 0 && total) at = atomicAdd(s.n_work, total);
    at = __shfl_sync(kFullMask, at, 0);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (own[u]) {
        const int i = at + __popc(m[u] & ((1u << lane) - 1u));
        s.work[i] = col[u];
        s.wid[i] = id[u];
        s.wcard[i] = cd[u];
        scored += s.tab_cnt[h0 + u * kThreads + lane];
      }
      at += __popc(m[u]);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    scored += __shfl_xor_sync(kFullMask, scored, off);
  if (lane == 0 && scored) atomicAdd(s.n_scored, scored);
  if (warp == kWarps - 1) {
    // The beam's lowest key; 0 if a lane is PAD or -inf.
    Key lowest = kTopKey;
    for (int b = lane; b < B; b += 32) lowest = kmin(lowest, beam_key(s, b));
    for (int off = 16; off > 0; off >>= 1)
      lowest = kmin(lowest, __shfl_xor_sync(kFullMask, lowest, off));
    if (lane == 0) *s.thr0 = lowest;
  }
}

// A row's intersection with the query over this thread's pieces (g, g + G,
// ...): 16-byte pieces when vec, else words.
__device__ __forceinline__ int row_inter(const uint32_t* row,
                                         const uint32_t* qw, int W, int vec,
                                         int g, int G) {
  int inter = 0;
  if (vec) {
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    const uint4* q4 = reinterpret_cast<const uint4*>(qw);
    for (int k = g; k < (W >> 2); k += G) {
      const uint4 a = r4[k], b = q4[k];
      inter += __popc(a.x & b.x) + __popc(a.y & b.y) + __popc(a.z & b.z) +
               __popc(a.w & b.w);
    }
  } else {
    for (int k = g; k < W; k += G) inter += __popc(row[k] & qw[k]);
  }
  return inter;
}

// Sum over the G lanes of each row group (G a power of 2 up to 32); every
// lane of the warp must call it.
__device__ __forceinline__ int group_sum(int x, int G) {
  for (int off = G >> 1; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

// The epilogue of U row-group iterations of a warp: the row of group gw
// in iteration u has its intersection in inter[u] on every lane of the
// group (after group_sum). Lane L takes the rows j = L, L + 32, ... of
// j = u * (32 / G) + gw and calls emit(u, gw, v), so one pass of the
// Jaccard epilogue serves up to 32 rows, not 32 / G. Every lane of the
// warp must call it.
template <int U, typename Emit>
__device__ __forceinline__ void spread_rows(const int (&inter)[U], int G,
                                            int lane, Emit emit) {
  const int rpw = 32 / G;
  const int sh = __ffs(rpw) - 1;  // rpw is a power of 2
  for (int j0 = 0; j0 < U * rpw; j0 += 32) {
    const int j = j0 + lane;
    const int u_of = j >> sh, gw = j & (rpw - 1);
    int v = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // G == 1: row j is lane j's own; else a lane of its group has it.
      const int x = G == 1 ? inter[u]
                           : __shfl_sync(kFullMask, inter[u], gw * G);
      if (u == u_of) v = x;
    }
    if (u_of < U) emit(u_of, gw, v);
  }
}

// Merge the warp's buffer (cnt keys) into its list x (descending; element
// j * 32 + lane in x[j]) and return the list's B-th key.
template <int P>
__device__ __forceinline__ Key flush_buffer(Key (&x)[P], const Key* buf,
                                            int cnt, int B, int lane) {
  Key b[1] = {lane < cnt ? buf[lane] : 0};
  sort_asc<1>(b, lane);
  // Half-cleaner of the list against the buffer ascending (below zeros
  // when P > 1): the top 32 P of both, bitonic; then a bitonic merge.
  x[P - 1] = kmax(x[P - 1], b[0]);
  merge_desc<P>(x, lane);
  Key kth = 0;
#pragma unroll
  for (int j = 0; j < P; ++j)
    if (j == ((B - 1) >> 5)) kth = x[j];
  return __shfl_sync(kFullMask, kth, (B - 1) & 31);
}

// Step 5: the new beam from the n_keys = B + n_work keys (each carries its
// column). Warp w keeps the top 32 P of its slice of them: a tile of 32 at
// a time, keys above the list's B-th key (and not below thr0) are
// buffered, and a full buffer is bitonic-sorted and merged into the list.
// The warps' lists then merge in a tree (kWarps / 2 pairs, then half as
// many, ...). Warp 0 writes ids (s.id at each key's column) and sims;
// empty slots come out PAD / -inf. Every thread of the block must call it.
template <int P>
__device__ inline void select_beam(int B, const State& s, int* out_ids,
                                   float* out_sims) {
  constexpr int KP = 32 * P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Key thr0 = *s.thr0;
  const Key low = thr0 ? thr0 - 1 : 0;  // keys must exceed it
  const int n_keys = B + *s.n_work;
  const int tiles = (n_keys + 31) >> 5;
  const int per = (tiles + kWarps - 1) / kWarps;
  const int t_end = min(tiles, (warp + 1) * per);
  Key* buf = s.buf + warp * 32;
  Key x[P];
#pragma unroll
  for (int j = 0; j < P; ++j) x[j] = 0;
  Key thr = low;
  int cnt = 0;
  for (int t = warp * per; t < t_end; ++t) {
    const int i = t * 32 + lane;
    const Key k = i < n_keys ? s.key[i] : 0;
    const bool keep = k > thr;
    const unsigned m = __ballot_sync(kFullMask, keep);
    if (m == 0) continue;
    const int n = __popc(m);
    if (cnt + n > 32) {
      __syncwarp();
      thr = kmax(flush_buffer<P>(x, buf, cnt, B, lane), low);
      cnt = 0;
      __syncwarp();
    }
    if (keep) buf[cnt + __popc(m & ((1u << lane) - 1u))] = k;
    cnt += n;
  }
  __syncwarp();
  if (cnt) flush_buffer<P>(x, buf, cnt, B, lane);
#pragma unroll
  for (int j = 0; j < P; ++j) s.list[warp * KP + j * 32 + lane] = x[j];
  __syncthreads();
  for (int half = kWarps / 2; half > 0; half >>= 1) {
    if (warp < half) {
      // Top 32 P of two descending lists: the first against the second
      // reversed is bitonic; a bitonic merge sorts it.
      const Key* o = s.list + (warp + half) * KP;
      if (o[0] != 0) {  // an empty list changes nothing
#pragma unroll
        for (int j = 0; j < P; ++j)
          x[j] = kmax(x[j], o[KP - 1 - (j * 32 + lane)]);
        merge_desc<P>(x, lane);
      }
      if (half > 1) {
#pragma unroll
        for (int j = 0; j < P; ++j) s.list[warp * KP + j * 32 + lane] = x[j];
      }
    }
    __syncthreads();
  }
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int e = j * 32 + lane;
      if (e < B) {
        out_ids[e] = x[j] ? s.id[key_col(x[j])] : kPadId;
        out_sims[e] = x[j] ? key_sim(x[j]) : neg_inf();
      }
    }
  }
}

// Step 5 for a beam wider than the warps' lists (B > kMaxBeam): the B-th
// largest of the n_keys = B + n_work keys by a radix select, 8 bits a
// pass from the top (a histogram of the keys that match the digits found
// so far; warps aggregate their lanes' equal digits into one shared
// atomic), then the keys at or above it -- distinct, as every nonzero key
// is -- gathered into `list` and each placed at its rank, the count of
// gathered keys above it. Exact on the 64-bit keys, so the same top B as
// the lists'. Every thread of the block must call it.
template <>
__device__ inline void select_beam<0>(int B, const State& s, int* out_ids,
                                      float* out_sims) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int n_keys = B + *s.n_work;
  int* hist = reinterpret_cast<int*>(s.buf);  // [256]
  int* found = hist + 256;                    // digit, rank left, n_sel
  Key prefix = 0, mask = 0;
  int need = B;  // the rank sought among the keys matching the prefix
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kThreads) hist[i] = 0;
    __syncthreads();
    for (int base = tid - lane; base < n_keys; base += kThreads) {
      const int i = base + lane;
      const Key k = i < n_keys ? s.key[i] : 0;
      const bool in = i < n_keys && (k & mask) == prefix;
      const int digit = in ? static_cast<int>((k >> shift) & 255) : 256;
      const unsigned peers = __match_any_sync(kFullMask, digit);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
    }
    __syncthreads();
    if (tid == 0) {
      // The digit holding the need-th largest: the counts of the digits
      // above it sum to less than need. (Digit 0 if all of them do.)
      int above = 0, d = 255;
      for (; d > 0; --d) {
        if (above + hist[d] >= need) break;
        above += hist[d];
      }
      found[0] = d;
      found[1] = need - above;
      found[2] = 0;
    }
    __syncthreads();
    prefix |= static_cast<Key>(found[0]) << shift;
    mask |= static_cast<Key>(255) << shift;
    need = found[1];
  }
  // prefix is now the B-th largest key; the zero keys (absent) stay out.
  for (int i = tid; i < n_keys; i += kThreads) {
    const Key k = s.key[i];
    if (k != 0 && k >= prefix) s.list[atomicAdd(&found[2], 1)] = k;
  }
  __syncthreads();
  const int n_sel = found[2];  // min(B, nonzero keys)
  for (int j = tid; j < n_sel; j += kThreads) {
    const Key k = s.list[j];
    int rank = 0;
    for (int i = 0; i < n_sel; ++i) rank += s.list[i] > k;
    out_ids[rank] = s.id[key_col(k)];
    out_sims[rank] = key_sim(k);
  }
  for (int e = n_sel + tid; e < B; e += kThreads) {
    out_ids[e] = kPadId;
    out_sims[e] = neg_inf();
  }
}

}  // namespace hop
}  // namespace repro
