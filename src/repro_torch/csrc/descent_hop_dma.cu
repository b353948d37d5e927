// Fused descent hop with the fingerprint rows gathered by Hopper's copy
// engine into a shared-memory ring (scorer "pallas_dma").
//
// Replaces the TPU kernel src/repro/kernels/descent_score/descent_score.py
// ::hop_pallas_dma (body _hop_kernel_dma), which every hop runs under
// `knn_serve --kernel --dma`. Same results as descent_hop.cu bit for bit:
// the lanes, the suppression and the selection are hop_common.cuh's.
//
// Design. One block of 512 threads per `block_q` queries, taken one after
// another through the same state: in shared memory, or for a state too
// large for it (wide beams) in a global workspace, one block per resident
// slot walking its groups of queries in turn (hop_common.cuh). Per query, steps 1-3 of
// hop_common.cuh stage the beam, gather the candidate ids into a hash
// table, suppress PAD / tombstoned / in-beam lanes and compact one owner
// lane per distinct id into a work list. Step 4 then runs a ring of
// `n_buffers` stages of `score_chunk` rows each, with warp-specialised
// roles and no block barrier inside it:
//   - the last 4 warps produce: for each stage they wait for the stage's
//     "empty" mbarrier, then copy the stage's owner rows (4W bytes each)
//     from the table into the stage. When a row is 16-byte aligned
//     (W % 4 == 0 and an aligned table) each row is ONE
//     cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes
//     1-D bulk copy -- Hopper's TMA engine copying a row, not a tile --
//     completing on the stage's "full" mbarrier, which each producer's
//     lane 0 armed with its copies' bytes (expect_tx) before issuing them.
//     Otherwise the producers issue 4-byte cp.async copies and each lane's
//     cp.async.mbarrier.arrive.noinc completes the same "full" mbarrier;
//   - the other 12 warps consume: wait for the stage's "full" mbarrier,
//     score its rows from shared memory (a group of G threads per row, as
//     in descent_hop.cu, 16-byte shared loads, and one Jaccard epilogue
//     per 32 rows), and release the stage with one arrive per warp on its
//     "empty" mbarrier.
// Then step 5 selects the new beam. The copies of the next stages are in
// flight while a stage is scored.
//
// Shards. repro_descent_hop_dma_sharded runs S shards' stacked tables and
// beams in one launch, shard s in grid row blockIdx.y = s, as
// descent_hop.cu does (hop_common.cuh shard_rows).
//
// Counters. Only owner rows are copied: the rows of lanes that repeat an
// id are never fetched. The byte counters keep the reference's meaning,
// derived from n_scored (lanes that survive PAD / tombstone / in-beam
// suppression, duplicates included): dma_bytes = n_scored * W * 4,
// bytes_saved = (C - n_scored) * W * 4, so the rows actually fetched (one
// per distinct surviving id) are at most dma_bytes / (4W).
//
// What bounds it: as descent_hop.cu, the scattered fingerprint rows of the
// distinct surviving ids (4W bytes each, under one integer operation per
// byte). The ring takes those reads off the scoring warps: one thread
// issues a row's copy with one instruction, the copy engine moves it. At
// 128-byte rows the copies land at ~8 bytes per cycle per SM, about half
// the rate of descent_hop.cu's 16-byte loads, so this hop is the slower:
// 0.035 ms against 0.026 at the main path's first hop (repro_torch.bench.
// hop_phases; NVIDIA H100 80GB HBM3, 700 W).

#include "hop_common.cuh"

namespace {

using repro::hop::kThreads;
using repro::hop::kWarps;

// Producer warps. A bulk copy's operands live in the warp's uniform
// registers, so a warp issues its lanes' copies one after another; four
// producers issue four at a time.
constexpr int kProducers = 4;
constexpr int kConsumers = kWarps - kProducers;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared.b64 st, [%0];\n\t}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// One row of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to shared memory by the copy engine, completing on `bar`.
__device__ __forceinline__ void bulk_row(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// An arrive on `bar` once this thread's earlier cp.async copies land.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

template <int P, bool kGlobal>
__global__ void __launch_bounds__(kThreads, 2)
descent_hop_dma_kernel(const int* __restrict__ graph,
                       const int* __restrict__ rev,
                       const uint32_t* __restrict__ words,
                       const int* __restrict__ card,
                       const uint8_t* __restrict__ tomb,
                       const uint32_t* __restrict__ q_words,
                       const int* __restrict__ q_card,
                       const int* __restrict__ beam_ids,
                       const float* __restrict__ beam_sims,
                       int* __restrict__ out_ids, float* __restrict__ out_sims,
                       int* __restrict__ n_scored, int* __restrict__ dma_bytes,
                       int* __restrict__ bytes_saved, int q, int cap, int W,
                       int kg, int kr, int B, int block_q, int chunk,
                       int n_buffers, int vec16,
                       unsigned char* __restrict__ workspace) {
  extern __shared__ __align__(128) unsigned char smem[];
  // Grid row blockIdx.y is the shard (hop_common.cuh shard_rows).
  using repro::hop::shard_rows;
  graph = shard_rows(graph, cap, kg);
  rev = shard_rows(rev, cap, kr);
  words = shard_rows(words, cap, W);
  card = shard_rows(card, cap, 1);
  tomb = shard_rows(tomb, cap, 1);
  beam_ids = shard_rows(beam_ids, q, B);
  beam_sims = shard_rows(beam_sims, q, B);
  out_ids = shard_rows(out_ids, q, B);
  out_sims = shard_rows(out_sims, q, B);
  n_scored = shard_rows(n_scored, q, 1);
  dma_bytes = shard_rows(dma_bytes, q, 1);
  bytes_saved = shard_rows(bytes_saved, q, 1);
  const repro::hop::Layout lo =
      repro::hop::layout(W, kg, kr, B, n_buffers * chunk, kGlobal);
  const repro::hop::State s = repro::hop::carve(
      kGlobal ? repro::hop::block_workspace(
                    workspace, repro::hop::workspace_stride(W, kg, kr, B))
              : smem,
      lo);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + lo.ring);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lo.bars);
  uint64_t* empty = full + repro::hop::kMaxBuffers;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = B * (kg + kr);
  const unsigned row_bytes = static_cast<unsigned>(W) * 4u;
  const int G = repro::hop::row_group(vec16 ? W >> 2 : W);
  const int rpw = 32 / G;
  const int gw = lane / G, g = lane & (G - 1);

  if (tid == 0) {
    for (int i = 0; i < n_buffers; ++i) {
      mbar_init(full + i, vec16 ? kProducers : 32 * kProducers);
      mbar_init(empty + i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Stages used so far, the same count in every thread: the k-th use of
  // stage k % n_buffers waits on phase parity (k / n_buffers) & 1.
  int used = 0;

  // The block's groups of block_q queries: blockIdx.x, blockIdx.x +
  // gridDim.x, ... (one group when the state is in shared memory).
  for (long long qi = static_cast<long long>(blockIdx.x) * block_q; qi < q;
       qi = (qi + 1) % block_q ? qi + 1
                               : qi + 1 + (gridDim.x - 1LL) * block_q) {
    // (1) beam staging (the barrier also publishes the mbarriers' init
    // and, from the second query on, ends the last one's selection).
    __syncthreads();
    repro::hop::stage_beam(beam_ids + qi * B, beam_sims + qi * B, tomb,
                           q_words + qi * W, W, B, s);
    __syncthreads();
    // (2) candidate ids, into the hash table.
    repro::hop::gather_lanes(graph, rev, kg, kr, B, s);
    __syncthreads();
    // (3) suppression, tombstones and one owner lane per id.
    repro::hop::classify_slots(card, tomb, B, s);
    __syncthreads();
    if (tid == 0) {
      const int scored = *s.n_scored;
      n_scored[qi] = scored;
      dma_bytes[qi] = scored * W * 4;
      bytes_saved[qi] = (C - scored) * W * 4;
    }

    // (4) the owners' rows through the ring; the keys overwrite the hash
    // table: the beam's, then the owners'.
    for (int b = tid; b < B; b += kThreads)
      s.key[b] = repro::hop::beam_key(s, b);
    const int n_work = *s.n_work;
    const int stages = (n_work + chunk - 1) / chunk;
    if (warp >= kConsumers) {
      // Producer p copies rows p * 32 + lane + k * 32 * kProducers of each
      // stage, having armed the stage's barrier with their bytes first.
      const int first = (warp - kConsumers) * 32 + lane;
      for (int st = 0; st < stages; ++st, ++used) {
        const int slot = used % n_buffers;
        mbar_wait(empty + slot, ((used / n_buffers) & 1) ^ 1);
        const int r0 = st * chunk;
        const int nr = min(chunk, n_work - r0);
        uint32_t* dst = ring + static_cast<size_t>(slot) * chunk * W;
        if (vec16) {
          int mine = 0;
          for (int r = first; r < nr; r += 32 * kProducers) ++mine;
          mine = __reduce_add_sync(repro::kFullMask, mine);
          if (lane == 0) mbar_arrive_expect_tx(full + slot, mine * row_bytes);
          __syncwarp();
          for (int r = first; r < nr; r += 32 * kProducers)
            bulk_row(dst + static_cast<size_t>(r) * W,
                     words + static_cast<long long>(s.wid[r0 + r]) * W,
                     row_bytes, full + slot);
        } else {
          for (int x = first; x < nr * W; x += 32 * kProducers) {
            const int r = x / W, w = x - r * W;
            repro::cp_async_4(
                dst + x,
                words + static_cast<long long>(s.wid[r0 + r]) * W + w);
          }
          cp_async_arrive(full + slot);
        }
      }
    } else {
      const int qcard = q_card[qi];
      for (int st = 0; st < stages; ++st, ++used) {
        const int slot = used % n_buffers;
        const int r0 = st * chunk;
        const int nr = min(chunk, n_work - r0);
        const uint32_t* src = ring + static_cast<size_t>(slot) * chunk * W;
        mbar_wait(full + slot, (used / n_buffers) & 1);
        constexpr int U = 3;  // 144 rows a pass of the 12 warps at W = 32
        const int stride = kConsumers * rpw;
        for (int base = warp * rpw; base < nr; base += stride * U) {
          int inter[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int r = base + u * stride + gw;
            inter[u] = repro::hop::group_sum(
                r < nr ? repro::hop::row_inter(
                             src + static_cast<size_t>(r) * W, s.qw, W,
                             vec16, g, G)
                       : 0,
                G);
          }
          repro::hop::spread_rows<U>(inter, G, lane, [&](int u, int row,
                                                         int v) {
            const int r = base + u * stride + row;
            if (r < nr)
              s.key[B + r0 + r] = repro::sim_key(
                  repro::jaccard_sim(v, qcard, s.wcard[r0 + r]),
                  s.work[r0 + r]);
          });
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + slot);
      }
    }
    __syncthreads();

    // (5) selection.
    repro::hop::select_beam<P>(B, s, out_ids + qi * B, out_sims + qi * B);
  }
}

using KernelFn = void (*)(const int*, const int*, const uint32_t*,
                          const int*, const uint8_t*, const uint32_t*,
                          const int*, const int*, const float*, int*, float*,
                          int*, int*, int*, int, int, int, int, int, int, int,
                          int, int, int, unsigned char*);

template <bool kGlobal>
KernelFn kernel_for(int B) {
  switch (repro::hop::list_regs(B)) {
    case 0: return descent_hop_dma_kernel<0, kGlobal>;
    case 1: return descent_hop_dma_kernel<1, kGlobal>;
    case 2: return descent_hop_dma_kernel<2, kGlobal>;
    case 4: return descent_hop_dma_kernel<4, kGlobal>;
    case 8: return descent_hop_dma_kernel<8, kGlobal>;
    default: return descent_hop_dma_kernel<16, kGlobal>;
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
           void* out_ids, void* out_sims, void* n_scored, void* dma_bytes,
           void* bytes_saved, int S, int cap, int q, int W, int kg, int kr,
           int B, int block_q, int chunk, int n_buffers, void* workspace,
           int grid, void* stream) {
  if (S < 1 || S > 65535 || cap < 0) return cudaErrorInvalidValue;
  const int global_state = workspace != nullptr;
  const size_t smem =
      repro::hop::layout(W, kg, kr, B, n_buffers * chunk, global_state).smem;
  const KernelFn fn = kernel_for(B, global_state);
  const cudaError_t e = allow_smem(fn, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vec16 =
      W % 4 == 0 && reinterpret_cast<uintptr_t>(words) % 16 == 0;
  fn<<<dim3(grid, S), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(graph), static_cast<const int*>(rev),
      static_cast<const uint32_t*>(words), static_cast<const int*>(card),
      static_cast<const uint8_t*>(tomb), static_cast<const uint32_t*>(q_words),
      static_cast<const int*>(q_card), static_cast<const int*>(beam_ids),
      static_cast<const float*>(beam_sims), static_cast<int*>(out_ids),
      static_cast<float*>(out_sims), static_cast<int*>(n_scored),
      static_cast<int*>(dma_bytes), static_cast<int*>(bytes_saved), q, cap,
      W, kg, kr, B, block_q, chunk, n_buffers, vec16,
      static_cast<unsigned char*>(workspace));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// The block's dynamic shared memory in bytes: the ring, n_buffers * chunk
// rows of W words, and its 2 * 4 mbarriers, then one query's state
// (hop_common.cuh's Layout) unless it is in global memory (global_state
// != 0). Queries of a block reuse the same state, so block_q does not
// enter it.
REPRO_EXPORT size_t repro_descent_hop_dma_smem_bytes(int W, int kg, int kr,
                                                     int B, int block_q,
                                                     int chunk,
                                                     int n_buffers,
                                                     int global_state) {
  (void)block_q;
  return repro::hop::layout(W, kg, kr, B, n_buffers * chunk,
                            global_state != 0).smem;
}

// Bytes of one block's workspace when the state is in global memory.
REPRO_EXPORT size_t repro_descent_hop_dma_workspace_stride(int W, int kg,
                                                           int kr, int B) {
  return repro::hop::workspace_stride(W, kg, kr, B);
}

// Blocks of this kernel one SM can hold at these parameters (shared
// memory, registers and threads together), or minus a CUDA error.
REPRO_EXPORT int repro_descent_hop_dma_blocks_per_sm(int W, int kg, int kr,
                                                     int B, int block_q,
                                                     int chunk,
                                                     int n_buffers,
                                                     int global_state) {
  const size_t smem = repro_descent_hop_dma_smem_bytes(
      W, kg, kr, B, block_q, chunk, n_buffers, global_state);
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
// out_ids / out_sims [q, B], n_scored / dma_bytes / bytes_saved [q]. Ids
// lie in [-1, n); all contiguous; block_q, chunk >= 1 and 1 <= n_buffers
// <= 4. One block per block_q queries, its state in shared memory. The
// wrapper launches through repro_descent_hop_dma_sharded (S = 1 for one
// table); this entry is the probes' (repro_torch.bench.hop_phases).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
REPRO_EXPORT int repro_descent_hop_dma(
    const void* graph, const void* rev, const void* words, const void* card,
    const void* tomb, const void* q_words, const void* q_card,
    const void* beam_ids, const void* beam_sims, void* out_ids,
    void* out_sims, void* n_scored, void* dma_bytes, void* bytes_saved,
    int q, int W, int kg, int kr, int B, int block_q, int chunk,
    int n_buffers, void* stream) {
  return launch(graph, rev, words, card, tomb, q_words, q_card, beam_ids,
                beam_sims, out_ids, out_sims, n_scored, dma_bytes,
                bytes_saved, 1, 0, q, W, kg, kr, B, block_q, chunk,
                n_buffers, nullptr, (q + block_q - 1) / block_q, stream);
}

// The sharded hop: tables graph [S, cap, kg], rev [S, cap, kr], words
// [S, cap, W], card [S, cap], tomb [S, cap]; beams and outputs [S, q, B],
// n_scored / dma_bytes / bytes_saved [S, q]; q_words [q, W] and q_card
// [q] shared by every shard. Ids in shard s's beams and adjacency are its
// own rows, in [-1, cap). Shard s runs in grid row s: `grid` blocks of
// block_q queries (grid = ceil(q / block_q) with the state in shared
// memory, workspace null), or with their states in `workspace` (S * grid
// slices of repro_descent_hop_dma_workspace_stride bytes). S = 1 is the
// single hop's launch. Launches on `stream` and returns
// cudaGetLastError().
REPRO_EXPORT int repro_descent_hop_dma_sharded(
    const void* graph, const void* rev, const void* words, const void* card,
    const void* tomb, const void* q_words, const void* q_card,
    const void* beam_ids, const void* beam_sims, void* out_ids,
    void* out_sims, void* n_scored, void* dma_bytes, void* bytes_saved,
    int S, int cap, int q, int W, int kg, int kr, int B, int block_q,
    int chunk, int n_buffers, void* workspace, int grid, void* stream) {
  if (grid < 1) return cudaErrorInvalidValue;
  return launch(graph, rev, words, card, tomb, q_words, q_card, beam_ids,
                beam_sims, out_ids, out_sims, n_scored, dma_bytes,
                bytes_saved, S, cap, q, W, kg, kr, B, block_q, chunk,
                n_buffers, workspace, grid, stream);
}
