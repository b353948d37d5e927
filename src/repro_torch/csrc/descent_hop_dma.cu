// Fused descent hop with the fingerprint rows gathered by cp.async into a
// shared-memory ring (scorer "pallas_dma").
//
// Replaces the TPU kernel src/repro/kernels/descent_score/descent_score.py
// ::hop_pallas_dma (body _hop_kernel_dma), which every hop runs under
// `knn_serve --kernel --dma`. Same results as descent_hop.cu bit for bit:
// the lanes, the suppression and the selection are hop_common.cuh's.
//
// Design. One block per `block_q` queries. Per query the block stages the
// beam, the C = B * (kg + kr) candidate ids and a suppression flag per lane
// (PAD, tombstoned or already in the beam: decided from ids alone; the
// tombstone flag is read per id from global memory, never staged, so the
// table's row count is not capped by shared memory). The candidate lanes
// are then scored in chunks of `score_chunk` lanes per query. Chunk c's
// surviving rows -- the fingerprint (W words) and the card word -- are
// copied by cp.async into ring stage c % n_buffers, 16 bytes a copy when a
// row starts on a 16-byte boundary (W % 4 == 0) and 4 bytes otherwise; a
// suppressed lane issues no copy. Each chunk's copies end with
// cp.async.commit_group; before chunk c is scored every thread waits with
// cp.async.wait_group<n_buffers - 1> and the block synchronises, so the
// copies of the next n_buffers - 1 chunks are in flight while chunk c is
// scored. `fetched` counts the rows whose copies were issued, per query,
// and the byte counters derive from it alone: dma_bytes = fetched * W * 4,
// bytes_saved = (C - fetched) * W * 4 (fingerprint bytes; the card word
// rides along uncounted, as in the reference). n_scored counts lanes
// scored, separately, so dma_bytes == n_scored * W * 4 is a check.
//
// TMA does not fit: these are per-row gathers of 4W bytes from scattered
// rows, and Hopper's TMA copies tiles.
//
// What bounds it: as descent_hop.cu, the scattered fingerprint rows of the
// surviving lanes (4W bytes each, under one integer operation per byte).
// The ring keeps n_buffers - 1 chunks of those reads in flight behind the
// scoring of the current one, instead of one dependent load per lane.

#include "hop_common.cuh"

namespace {

using repro::hop::kThreads;
using repro::hop::SelectScratch;

using repro::cp_async_16;
using repro::cp_async_4;
using repro::cp_async_commit;
using repro::cp_async_wait;

// At most n_buffers - 1 committed groups may still be pending.
__device__ __forceinline__ void wait_ring(int n_buffers) {
  switch (n_buffers) {
    case 1: cp_async_wait<0>(); break;
    case 2: cp_async_wait<1>(); break;
    case 3: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// Byte offsets of the block's dynamic shared memory. The ring comes first,
// so each 4W-byte row of it is 16-byte aligned whenever W % 4 == 0.
struct Layout {
  size_t ring_words;  // uint32 [n_buffers][block_q * chunk][W]
  size_t ring_card;   // int    [n_buffers][block_q * chunk]
  size_t ids;         // int    [block_q][L]
  size_t sims;        // float  [block_q][L]
  size_t qw;          // uint32 [block_q][W]
  size_t counts;      // int    [block_q][2]: lanes scored, rows fetched
  size_t scratch;     // SelectScratch
  size_t flags;       // uint8  [block_q][C]: lane survives suppression
  size_t total;
};

__host__ __device__ inline Layout layout(int W, int kg, int kr, int B,
                                         int block_q, int chunk,
                                         int n_buffers) {
  const size_t C = static_cast<size_t>(B) * (kg + kr);
  const size_t L = B + C;
  const size_t rows = static_cast<size_t>(n_buffers) * block_q * chunk;
  Layout o;
  o.ring_words = 0;
  o.ring_card = o.ring_words + rows * W * 4;
  o.ids = o.ring_card + rows * 4;
  o.sims = o.ids + block_q * L * 4;
  o.qw = o.sims + block_q * L * 4;
  o.counts = o.qw + static_cast<size_t>(block_q) * W * 4;
  o.scratch = o.counts + static_cast<size_t>(block_q) * 2 * 4;
  o.flags = o.scratch + sizeof(SelectScratch);
  o.total = o.flags + block_q * C;
  return o;
}

__global__ void __launch_bounds__(kThreads)
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
                       int* __restrict__ bytes_saved, int q, int W, int kg,
                       int kr, int B, int block_q, int chunk, int n_buffers,
                       int vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lo = layout(W, kg, kr, B, block_q, chunk, n_buffers);
  uint32_t* ring_w = reinterpret_cast<uint32_t*>(smem + lo.ring_words);
  int* ring_c = reinterpret_cast<int*>(smem + lo.ring_card);
  int* s_id = reinterpret_cast<int*>(smem + lo.ids);
  float* s_sim = reinterpret_cast<float*>(smem + lo.sims);
  uint32_t* s_qw = reinterpret_cast<uint32_t*>(smem + lo.qw);
  int* s_cnt = reinterpret_cast<int*>(smem + lo.counts);
  SelectScratch* scr = reinterpret_cast<SelectScratch*>(smem + lo.scratch);
  uint8_t* s_need = smem + lo.flags;

  const int tid = threadIdx.x;
  const long long q0 = static_cast<long long>(blockIdx.x) * block_q;
  const int qn = static_cast<int>(min(static_cast<long long>(block_q),
                                      q - q0));
  const int C = B * (kg + kr);
  const int L = B + C;
  const float ninf = repro::neg_inf();

  // (1) beams (dead lanes to PAD / -inf) and query fingerprints.
  for (int j = 0; j < qn; ++j)
    repro::hop::stage_beam(beam_ids + (q0 + j) * B, beam_sims + (q0 + j) * B,
                           tomb, B, s_id + j * L, s_sim + j * L);
  for (int x = tid; x < qn * W; x += kThreads) s_qw[x] = q_words[q0 * W + x];
  for (int x = tid; x < 2 * qn; x += kThreads) s_cnt[x] = 0;
  __syncthreads();

  // (2) candidate ids and suppression flags; no fingerprint is read here.
  for (int x = tid; x < qn * C; x += kThreads) {
    const int j = x / C;
    const int c = x - j * C;
    const int* beam = s_id + j * L;
    const int id =
        repro::hop::candidate_id(graph, rev, tomb, beam, c, B, kg, kr);
    s_id[j * L + B + c] = id;
    s_sim[j * L + B + c] = ninf;
    s_need[x] = repro::hop::survives(id, beam, B);
  }
  __syncthreads();

  // (3) chunked scoring through the ring.
  const int n_chunks = (C + chunk - 1) / chunk;
  const int pieces = vec16 ? W / 4 : W;  // copies per fingerprint row
  const int per_lane = pieces + 1;       // and one for the card word
  const size_t stage_rows = static_cast<size_t>(block_q) * chunk;

  auto issue = [&](int ci) {
    const int c0 = ci * chunk;
    const int ch = min(chunk, C - c0);
    uint32_t* rw = ring_w + (ci % n_buffers) * stage_rows * W;
    int* rc = ring_c + (ci % n_buffers) * stage_rows;
    for (int x = tid; x < qn * ch * per_lane; x += kThreads) {
      const int lane = x / per_lane;
      const int piece = x - lane * per_lane;
      const int j = lane / ch;
      const int l = lane - j * ch;
      if (!s_need[j * C + c0 + l]) continue;
      const long long id = s_id[j * L + B + c0 + l];
      const size_t row = static_cast<size_t>(j) * chunk + l;
      if (piece == pieces) {
        cp_async_4(rc + row, card + id);
        atomicAdd(&s_cnt[2 * j + 1], 1);
      } else if (vec16) {
        cp_async_16(rw + row * W + 4 * piece, words + id * W + 4 * piece);
      } else {
        cp_async_4(rw + row * W + piece, words + id * W + piece);
      }
    }
  };

  auto score = [&](int ci) {
    const int c0 = ci * chunk;
    const int ch = min(chunk, C - c0);
    const uint32_t* rw = ring_w + (ci % n_buffers) * stage_rows * W;
    const int* rc = ring_c + (ci % n_buffers) * stage_rows;
    for (int lane = tid; lane < qn * ch; lane += kThreads) {
      const int j = lane / ch;
      const int l = lane - j * ch;
      if (!s_need[j * C + c0 + l]) continue;
      const int row = j * chunk + l;
      const uint32_t* fp = rw + static_cast<size_t>(row) * W;
      const uint32_t* qw = s_qw + j * W;
      // Start each row at its own word, so a warp's reads of consecutive
      // ring rows fall in different banks; the integer sum is order-free.
      int w = row % W;
      int inter = 0;
      for (int i = 0; i < W; ++i) {
        inter += __popc(fp[w] & qw[w]);
        if (++w == W) w = 0;
      }
      s_sim[j * L + B + c0 + l] =
          repro::jaccard_sim(inter, q_card[q0 + j], rc[row]);
      atomicAdd(&s_cnt[2 * j], 1);
    }
  };

  for (int ci = 0; ci < n_buffers - 1; ++ci) {
    if (ci < n_chunks) issue(ci);
    cp_async_commit();
  }
  for (int ci = 0; ci < n_chunks; ++ci) {
    if (ci + n_buffers - 1 < n_chunks) issue(ci + n_buffers - 1);
    cp_async_commit();
    wait_ring(n_buffers);
    __syncthreads();
    score(ci);
    __syncthreads();  // stage ci % n_buffers is free for the next issue
  }
  __syncthreads();

  for (int j = tid; j < qn; j += kThreads) {
    const int fetched = s_cnt[2 * j + 1];
    n_scored[q0 + j] = s_cnt[2 * j];
    dma_bytes[q0 + j] = fetched * W * 4;
    bytes_saved[q0 + j] = (C - fetched) * W * 4;
  }

  // (4) the new beams, one query at a time over the whole block.
  for (int j = 0; j < qn; ++j)
    repro::hop::select_beam(s_id + j * L, s_sim + j * L, L, B,
                            out_ids + (q0 + j) * B, out_sims + (q0 + j) * B,
                            scr);
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// The block's dynamic shared memory in bytes: the ring,
// n_buffers * block_q * chunk * (W + 1) * 4, plus per query the staged
// beam and candidate lanes (ids and sims), the query fingerprint, two
// counters and a flag per candidate lane, plus the selection scratch.
REPRO_EXPORT size_t repro_descent_hop_dma_smem_bytes(int W, int kg, int kr,
                                                     int B, int block_q,
                                                     int chunk,
                                                     int n_buffers) {
  return layout(W, kg, kr, B, block_q, chunk, n_buffers).total;
}

// Blocks of this kernel one SM can hold at these parameters (shared
// memory, registers and threads together), or minus a CUDA error.
REPRO_EXPORT int repro_descent_hop_dma_blocks_per_sm(int W, int kg, int kr,
                                                     int B, int block_q,
                                                     int chunk,
                                                     int n_buffers) {
  const size_t smem = layout(W, kg, kr, B, block_q, chunk, n_buffers).total;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)  // as at launch: the default cap is 48 KB
    e = cudaFuncSetAttribute(descent_hop_dma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, descent_hop_dma_kernel, kThreads, smem);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

// Tables: graph [n, kg], rev [n, kr], words [n, W] (uint32 bit patterns),
// card [n], tomb [n] (0 = live). Queries: q_words [q, W], q_card [q],
// beam_ids / beam_sims [q, B]. Outputs: out_ids / out_sims [q, B],
// n_scored / dma_bytes / bytes_saved [q]. Ids lie in [-1, n); all
// contiguous; block_q, chunk >= 1 and 1 <= n_buffers <= 4. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
REPRO_EXPORT int repro_descent_hop_dma(
    const void* graph, const void* rev, const void* words, const void* card,
    const void* tomb, const void* q_words, const void* q_card,
    const void* beam_ids, const void* beam_sims, void* out_ids,
    void* out_sims, void* n_scored, void* dma_bytes, void* bytes_saved,
    int q, int W, int kg, int kr, int B, int block_q, int chunk,
    int n_buffers, void* stream) {
  const size_t smem = layout(W, kg, kr, B, block_q, chunk, n_buffers).total;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        descent_hop_dma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int vec16 =
      W % 4 == 0 && reinterpret_cast<uintptr_t>(words) % 16 == 0;
  const int grid = (q + block_q - 1) / block_q;
  descent_hop_dma_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(graph), static_cast<const int*>(rev),
      static_cast<const uint32_t*>(words), static_cast<const int*>(card),
      static_cast<const uint8_t*>(tomb), static_cast<const uint32_t*>(q_words),
      static_cast<const int*>(q_card), static_cast<const int*>(beam_ids),
      static_cast<const float*>(beam_sims), static_cast<int*>(out_ids),
      static_cast<float*>(out_sims), static_cast<int*>(n_scored),
      static_cast<int*>(dma_bytes), static_cast<int*>(bytes_saved), q, W, kg,
      kr, B, block_q, chunk, n_buffers, vec16);
  return static_cast<int>(cudaGetLastError());
}
