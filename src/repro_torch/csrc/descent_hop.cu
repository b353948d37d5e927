// Fused descent hop: one friend-of-a-friend expansion of every query's beam.
//
// Replaces the TPU kernel src/repro/kernels/descent_score/descent_score.py
// ::hop_pallas (body _hop_kernel, helpers _mask_dead_beam / _suppress /
// _merge), which every hop of every query runs under scorer "pallas".
//
// Design. One block of 512 threads per query, in the five steps of
// hop_common.cuh (shared with the DMA hop, descent_hop_dma.cu): stage the
// beam, gather the B * (kg + kr) candidate ids into a shared-memory hash
// table, suppress PAD / tombstoned / in-beam lanes and keep one "owner"
// lane per distinct id, score the owners, select the top B. Step 4 here
// reads each owner's fingerprint row straight from global memory: a group
// of G threads per row (G = W / 4 at W % 4 == 0, 8 at the main path's
// W = 32), one 16-byte load each, so one warp load instruction moves
// 32 / G whole rows; each thread pops its words and a __shfl_xor over the
// group sums the intersection (an integer sum: the order does not move a
// bit). Each group keeps 6 rows in flight, and the Jaccard epilogue of a
// warp's 24 rows runs once, one row per lane. W % 4 != 0 (or a table that is
// not 16-byte aligned) reads words in the same grouping. The selection is
// an exact parallel top-B over 64-bit (sim, column) keys: per-warp lists
// filtered against their B-th key and the beam's lowest key, merged by
// warp-shuffle bitonic networks, then in a tree across the warps.
//
// Shards. The sharded placement's hop (repro_descent_hop_sharded) stacks
// S shards' tables and beams and runs shard s in grid row blockIdx.y = s:
// one launch for all shards, the counterpart of the TPU kernel's
// pallas_call batched over the shard axis by jax.vmap. A block offsets
// its table pointers by s * cap rows and its beam and output pointers by
// s * q rows (hop_common.cuh shard_rows); the queries are every shard's.
//
// Wide beams. A query's state grows with B * (kg + kr) lanes (~37 bytes a
// lane): at kg + kr = 60 it fills a block's shared memory above ~100 beam
// lanes. Such a state lives in a global workspace instead (one block per
// resident slot, each walking its queries in turn, so the workspace is
// grid x state, not q x state).
// Beams above kMaxBeam = 512 lanes outgrow the warps' register lists and
// are selected by an exact radix select over the block (select_beam<0>).
//
// What bounds it: per query ~B*(kg+kr)*4 bytes of adjacency plus one
// fingerprint row (4W bytes) per distinct surviving id, against ~3W
// integer operations per row -- under one operation per byte, so the
// least time is the bytes, and the kernel is bound by the latency of the
// dependent reads (beam, adjacency, then tombstone and card, then row).
// One block per query at 512 threads puts 16 warps of each query on an
// SM, and a 256-query wave about 32 warps on each of the 132 SMs. At the
// main path's first hop the kernel takes 0.026 ms, and the row reads are
// its largest phase, ~38% of a block's cycles (repro_torch.bench.
// hop_phases; NVIDIA H100 80GB HBM3, 700 W).

#include "hop_common.cuh"

namespace {

using repro::hop::kThreads;
using repro::hop::kWarps;

// The intersections of U rows in global memory with the query, over this
// thread's pieces of each (g, g + G, ...; 16 bytes when vec, else a word):
// the U rows' loads of one piece are issued together.
template <int U>
__device__ __forceinline__ void rows_inter(const uint32_t* const (&rows)[U],
                                           const bool (&ok)[U],
                                           const uint32_t* qw, int W, int vec,
                                           int g, int G, int (&inter)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) inter[u] = 0;
  if (vec) {
    const uint4* q4 = reinterpret_cast<const uint4*>(qw);
    for (int k = g; k < (W >> 2); k += G) {
      uint4 a[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        a[u] = ok[u] ? __ldg(reinterpret_cast<const uint4*>(rows[u]) + k)
                     : make_uint4(0u, 0u, 0u, 0u);
      const uint4 b = q4[k];
#pragma unroll
      for (int u = 0; u < U; ++u)
        inter[u] += __popc(a[u].x & b.x) + __popc(a[u].y & b.y) +
                    __popc(a[u].z & b.z) + __popc(a[u].w & b.w);
    }
  } else {
    for (int k = g; k < W; k += G) {
      uint32_t a[U];
#pragma unroll
      for (int u = 0; u < U; ++u) a[u] = ok[u] ? __ldg(rows[u] + k) : 0u;
      const uint32_t b = qw[k];
#pragma unroll
      for (int u = 0; u < U; ++u) inter[u] += __popc(a[u] & b);
    }
  }
}

// One query's hop in the block's state `s` (steps 1-5 of hop_common.cuh).
template <int P>
__device__ __forceinline__ void hop_query(
    const int* __restrict__ graph, const int* __restrict__ rev,
    const uint32_t* __restrict__ words, const int* __restrict__ card,
    const uint8_t* __restrict__ tomb, const uint32_t* __restrict__ q_words,
    const int* __restrict__ q_card, const int* __restrict__ beam_ids,
    const float* __restrict__ beam_sims, int* __restrict__ out_ids,
    float* __restrict__ out_sims, int* __restrict__ n_scored, int W, int kg,
    int kr, int B, int vec16, const repro::hop::State& s, long long q) {
  // (1) beam staging.
  repro::hop::stage_beam(beam_ids + q * B, beam_sims + q * B, tomb,
                         q_words + q * W, W, B, s);
  __syncthreads();
  // (2) candidate ids, into the hash table.
  repro::hop::gather_lanes(graph, rev, kg, kr, B, s);
  __syncthreads();
  // (3) suppression, tombstones and one owner lane per id.
  repro::hop::classify_slots(card, tomb, B, s);
  __syncthreads();
  if (threadIdx.x == 0) n_scored[q] = *s.n_scored;

  // (4) row loads + popcounts of the owners, 6 rows per group in flight;
  // the keys overwrite the hash table: the beam's, then the owners'.
  for (int b = threadIdx.x; b < B; b += kThreads)
    s.key[b] = repro::hop::beam_key(s, b);
  {
    constexpr int U = 6;  // two passes over the main path's ~680 owners
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_work = *s.n_work;
    const int G = repro::hop::row_group(vec16 ? W >> 2 : W);
    const int rpw = 32 / G;
    const int gw = lane / G, g = lane & (G - 1);
    const int stride = kWarps * rpw;
    const int qcard = q_card[q];
    for (int base = warp * rpw; base < n_work; base += stride * U) {
      const uint32_t* rows[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * stride + gw;
        ok[u] = i < n_work;
        rows[u] = words + (ok[u] ? static_cast<long long>(s.wid[i]) * W : 0);
      }
      int inter[U];
      rows_inter<U>(rows, ok, s.qw, W, vec16, g, G, inter);
#pragma unroll
      for (int u = 0; u < U; ++u) inter[u] = repro::hop::group_sum(inter[u], G);
      repro::hop::spread_rows<U>(inter, G, lane, [&](int u, int row, int v) {
        const int i = base + u * stride + row;
        if (i < n_work)
          s.key[B + i] = repro::sim_key(
              repro::jaccard_sim(v, qcard, s.wcard[i]), s.work[i]);
      });
    }
  }
  __syncthreads();

  // (5) selection.
  repro::hop::select_beam<P>(B, s, out_ids + q * B, out_sims + q * B);
}

// A block per query with its state in shared memory (kGlobal false, grid
// = q), or a block per resident slot, its state in the block's slice of
// `workspace`, walking queries blockIdx.x, blockIdx.x + gridDim.x, ...;
// grid row blockIdx.y is the shard (tables of `cap` rows each).
template <int P, bool kGlobal>
__global__ void __launch_bounds__(kThreads, 2)
descent_hop_kernel(const int* __restrict__ graph, const int* __restrict__ rev,
                   const uint32_t* __restrict__ words,
                   const int* __restrict__ card,
                   const uint8_t* __restrict__ tomb,
                   const uint32_t* __restrict__ q_words,
                   const int* __restrict__ q_card,
                   const int* __restrict__ beam_ids,
                   const float* __restrict__ beam_sims,
                   int* __restrict__ out_ids, float* __restrict__ out_sims,
                   int* __restrict__ n_scored, int nq, int cap, int W,
                   int kg, int kr, int B, int vec16,
                   unsigned char* __restrict__ workspace) {
  extern __shared__ __align__(16) unsigned char smem[];
  using repro::hop::shard_rows;
  graph = shard_rows(graph, cap, kg);
  rev = shard_rows(rev, cap, kr);
  words = shard_rows(words, cap, W);
  card = shard_rows(card, cap, 1);
  tomb = shard_rows(tomb, cap, 1);
  beam_ids = shard_rows(beam_ids, nq, B);
  beam_sims = shard_rows(beam_sims, nq, B);
  out_ids = shard_rows(out_ids, nq, B);
  out_sims = shard_rows(out_sims, nq, B);
  n_scored = shard_rows(n_scored, nq, 1);
  const repro::hop::Layout lo = repro::hop::layout(W, kg, kr, B, 0, kGlobal);
  const repro::hop::State s = repro::hop::carve(
      kGlobal ? repro::hop::block_workspace(
                    workspace, repro::hop::workspace_stride(W, kg, kr, B))
              : smem,
      lo);
  for (long long q = blockIdx.x; q < nq; q += gridDim.x) {
    if (q != blockIdx.x) __syncthreads();  // the last query is done
    hop_query<P>(graph, rev, words, card, tomb, q_words, q_card, beam_ids,
                 beam_sims, out_ids, out_sims, n_scored, W, kg, kr, B, vec16,
                 s, q);
  }
}

using KernelFn = void (*)(const int*, const int*, const uint32_t*,
                          const int*, const uint8_t*, const uint32_t*,
                          const int*, const int*, const float*, int*, float*,
                          int*, int, int, int, int, int, int, int,
                          unsigned char*);

template <bool kGlobal>
KernelFn kernel_for(int B) {
  switch (repro::hop::list_regs(B)) {
    case 0: return descent_hop_kernel<0, kGlobal>;
    case 1: return descent_hop_kernel<1, kGlobal>;
    case 2: return descent_hop_kernel<2, kGlobal>;
    case 4: return descent_hop_kernel<4, kGlobal>;
    case 8: return descent_hop_kernel<8, kGlobal>;
    default: return descent_hop_kernel<16, kGlobal>;
  }
}

KernelFn kernel_for(int B, int global_state) {
  return global_state ? kernel_for<true>(B) : kernel_for<false>(B);
}

// Set before every launch, on the launch's device: the attribute is per
// device, so nothing is cached.
cudaError_t allow_smem(KernelFn fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;  // the default cap
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// S shards of `cap` table rows each in grid rows y (S = 1: the single
// placement, cap unused); `grid` blocks per shard in x.
int launch(const void* graph, const void* rev, const void* words,
           const void* card, const void* tomb, const void* q_words,
           const void* q_card, const void* beam_ids, const void* beam_sims,
           void* out_ids, void* out_sims, void* n_scored, int S, int cap,
           int q, int W, int kg, int kr, int B, void* workspace, int grid,
           void* stream) {
  if (S < 1 || S > 65535 || cap < 0) return cudaErrorInvalidValue;
  const int global_state = workspace != nullptr;
  const size_t smem =
      repro::hop::layout(W, kg, kr, B, 0, global_state).smem;
  const KernelFn fn = kernel_for(B, global_state);
  const cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // At W % 4 == 0 every shard's table (cap * W words in) is as aligned as
  // the first.
  const int vec16 = W % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(words) % 16 == 0;
  fn<<<dim3(grid, S), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(graph), static_cast<const int*>(rev),
      static_cast<const uint32_t*>(words), static_cast<const int*>(card),
      static_cast<const uint8_t*>(tomb), static_cast<const uint32_t*>(q_words),
      static_cast<const int*>(q_card), static_cast<const int*>(beam_ids),
      static_cast<const float*>(beam_sims), static_cast<int*>(out_ids),
      static_cast<float*>(out_sims), static_cast<int*>(n_scored), q, cap, W,
      kg, kr, B, vec16, static_cast<unsigned char*>(workspace));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// The block's dynamic shared memory in bytes (hop_common.cuh's Layout
// without a ring): the state, or nothing when the state is in global
// memory (global_state != 0).
REPRO_EXPORT size_t repro_descent_hop_smem_bytes(int W, int kg, int kr,
                                                 int B, int global_state) {
  return repro::hop::layout(W, kg, kr, B, 0, global_state != 0).smem;
}

// Bytes of one block's workspace when the state is in global memory.
REPRO_EXPORT size_t repro_descent_hop_workspace_stride(int W, int kg, int kr,
                                                       int B) {
  return repro::hop::workspace_stride(W, kg, kr, B);
}

// Blocks of this kernel one SM can hold at these parameters (shared
// memory, registers and threads together), or minus a CUDA error.
REPRO_EXPORT int repro_descent_hop_blocks_per_sm(int W, int kg, int kr,
                                                 int B, int global_state) {
  const size_t smem =
      repro_descent_hop_smem_bytes(W, kg, kr, B, global_state);
  const KernelFn fn = kernel_for(B, global_state);
  cudaError_t e = allow_smem(fn, smem);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                      smem);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

// Tables: graph [n, kg], rev [n, kr], words [n, W] (uint32 bit patterns),
// card [n], tomb [n] (0 = live). Queries: q_words [q, W], q_card [q],
// beam_ids / beam_sims [q, B], no id repeated in a beam row. Outputs:
// out_ids / out_sims [q, B], n_scored [q]. Adjacency and beam ids lie in
// [-1, n). All contiguous. One block per query, its state in shared
// memory. Launches on `stream` and returns cudaGetLastError() (0 on
// success). The wrapper launches through repro_descent_hop_sharded (S =
// 1 for one table); this entry is the probes' (repro_torch.bench.
// hop_phases), whose signature older checkouts share.
REPRO_EXPORT int repro_descent_hop(const void* graph, const void* rev,
                                   const void* words, const void* card,
                                   const void* tomb, const void* q_words,
                                   const void* q_card, const void* beam_ids,
                                   const void* beam_sims, void* out_ids,
                                   void* out_sims, void* n_scored, int q,
                                   int W, int kg, int kr, int B,
                                   void* stream) {
  return launch(graph, rev, words, card, tomb, q_words, q_card, beam_ids,
                beam_sims, out_ids, out_sims, n_scored, 1, 0, q, W, kg, kr, B,
                nullptr, q, stream);
}

// The sharded hop: tables graph [S, cap, kg], rev [S, cap, kr], words
// [S, cap, W], card [S, cap], tomb [S, cap]; beams and outputs [S, q, B],
// n_scored [S, q]; q_words [q, W] and q_card [q] shared by every shard.
// Ids in shard s's beams and adjacency are its own rows, in [-1, cap).
// Shard s runs in grid row s, one block per query with its state in
// shared memory (workspace null, grid = q), or `grid` blocks per shard
// with their states in `workspace` (S * grid slices of
// repro_descent_hop_workspace_stride bytes). S = 1 is the single hop's
// launch. Launches on `stream` and returns cudaGetLastError().
REPRO_EXPORT int repro_descent_hop_sharded(
    const void* graph, const void* rev, const void* words, const void* card,
    const void* tomb, const void* q_words, const void* q_card,
    const void* beam_ids, const void* beam_sims, void* out_ids,
    void* out_sims, void* n_scored, int S, int cap, int q, int W, int kg,
    int kr, int B, void* workspace, int grid, void* stream) {
  if (grid < 1) return cudaErrorInvalidValue;
  return launch(graph, rev, words, card, tomb, q_words, q_card, beam_ids,
                beam_sims, out_ids, out_sims, n_scored, S, cap, q, W, kg, kr,
                B, workspace, grid, stream);
}
