// Fused descent hop: one friend-of-a-friend expansion of every query's beam.
//
// Replaces the TPU kernel src/repro/kernels/descent_score/descent_score.py
// ::hop_pallas (body _hop_kernel, helpers _mask_dead_beam / _suppress /
// _merge), which every hop of every query runs under scorer "pallas".
//
// Design. One block per query; the lanes are [beam | fwd | rev] in the
// reference's column order, B + C of them with C = B * (kg + kr):
//   1. stage the B beam ids and sims in shared memory, dead lanes (rows
//      marked in `tomb`) turned to PAD / -inf;
//   2. gather the C candidate ids (forward then reverse neighbours of each
//      beam lane; PAD under a PAD beam lane; tombstoned ids to PAD) and
//      decide, before any fingerprint is read, which lanes survive: not
//      PAD and not already in the beam. Suppressed lanes load nothing.
//      Survivors are counted (n_scored) and scored with GoldFinger Jaccard,
//      the intersection a __popc over the W packed words -- the same code
//      for every W (the TPU switched to a bit-plane matmul at W >= 64; the
//      numbers are identical);
//   3. select the new beam by B rounds of a block-wide (max sim, min column)
//      reduction, retiring every lane that carries the round's winning id:
//      exactly select_topk(..., dedup_ids=True). Once the best remaining sim
//      is -inf every later round is too, and the rest of the beam is PAD.
// Steps 1, 2's ids and suppression, and 3 are hop_common.cuh's, shared with
// the DMA hop (descent_hop_dma.cu).
//
// What bounds it: per query ~B*(kg+kr)*4 bytes of adjacency plus one
// fingerprint row (4W bytes) per surviving lane, against ~3W integer
// operations per surviving lane -- under one operation per byte, so it is
// bound by the latency and bandwidth of those scattered row reads. The
// suppression before scoring is what cuts the bytes: duplicate and
// in-beam lanes never touch their fingerprint row.

#include "hop_common.cuh"

namespace {

using repro::hop::kThreads;
using repro::hop::SelectScratch;

__global__ void __launch_bounds__(kThreads)
descent_hop_kernel(const int* __restrict__ graph, const int* __restrict__ rev,
                   const uint32_t* __restrict__ words,
                   const int* __restrict__ card,
                   const uint8_t* __restrict__ tomb,
                   const uint32_t* __restrict__ q_words,
                   const int* __restrict__ q_card,
                   const int* __restrict__ beam_ids,
                   const float* __restrict__ beam_sims,
                   int* __restrict__ out_ids, float* __restrict__ out_sims,
                   int* __restrict__ n_scored, int W, int kg, int kr,
                   int B) {
  extern __shared__ unsigned char smem_raw[];
  const int C = B * (kg + kr);
  const int L = B + C;
  int* s_id = reinterpret_cast<int*>(smem_raw);              // [L]
  float* s_sim = reinterpret_cast<float*>(s_id + L);         // [L]
  uint32_t* s_qw = reinterpret_cast<uint32_t*>(s_sim + L);   // [W]
  SelectScratch* scr = reinterpret_cast<SelectScratch*>(s_qw + W);
  int* s_count = reinterpret_cast<int*>(scr + 1);            // [1]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long q = blockIdx.x;
  const float ninf = repro::neg_inf();

  // (1) beam lanes, tombstoned rows dropped to PAD / -inf.
  repro::hop::stage_beam(beam_ids + q * B, beam_sims + q * B, tomb, B, s_id,
                         s_sim);
  for (int w = tid; w < W; w += kThreads) s_qw[w] = q_words[q * W + w];
  if (tid == 0) *s_count = 0;
  __syncthreads();

  // (2) gather candidate ids, suppress, score the survivors.
  const int qcard = q_card[q];
  int scored = 0;
  for (int c = tid; c < C; c += kThreads) {
    const int id =
        repro::hop::candidate_id(graph, rev, tomb, s_id, c, B, kg, kr);
    float sim = ninf;
    if (repro::hop::survives(id, s_id, B)) {
      ++scored;
      const long long row = static_cast<long long>(id) * W;
      int inter = 0;
      for (int w = 0; w < W; ++w)
        inter += __popc(__ldg(words + row + w) & s_qw[w]);
      sim = repro::jaccard_sim(inter, qcard, card[id]);
    }
    s_id[B + c] = id;
    s_sim[B + c] = sim;
  }
  for (int off = 16; off > 0; off >>= 1)
    scored += __shfl_down_sync(0xffffffffu, scored, off);
  if (lane == 0 && scored) atomicAdd(s_count, scored);
  __syncthreads();
  if (tid == 0) n_scored[q] = *s_count;

  // (3) B rounds of (max sim, min column) with winner-id retirement.
  repro::hop::select_beam(s_id, s_sim, L, B, out_ids + q * B,
                          out_sims + q * B, scr);
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

REPRO_EXPORT size_t repro_descent_hop_smem_bytes(int W, int kg, int kr,
                                                 int B) {
  const size_t L = static_cast<size_t>(B) * (1 + kg + kr);
  return L * (sizeof(int) + sizeof(float)) + sizeof(uint32_t) * W +
         sizeof(SelectScratch) + sizeof(int);
}

// Blocks of this kernel one SM can hold at these parameters (shared
// memory, registers and threads together), or minus a CUDA error.
REPRO_EXPORT int repro_descent_hop_blocks_per_sm(int W, int kg, int kr,
                                                 int B) {
  const size_t smem = repro_descent_hop_smem_bytes(W, kg, kr, B);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)  // as at launch: the default cap is 48 KB
    e = cudaFuncSetAttribute(descent_hop_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, descent_hop_kernel, kThreads, smem);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

// Tables: graph [n, kg], rev [n, kr], words [n, W] (uint32 bit patterns),
// card [n], tomb [n] (0 = live). Queries: q_words [q, W], q_card [q],
// beam_ids / beam_sims [q, B]. Outputs: out_ids / out_sims [q, B],
// n_scored [q]. Adjacency and beam ids lie in [-1, n). All contiguous.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
REPRO_EXPORT int repro_descent_hop(const void* graph, const void* rev,
                                   const void* words, const void* card,
                                   const void* tomb, const void* q_words,
                                   const void* q_card, const void* beam_ids,
                                   const void* beam_sims, void* out_ids,
                                   void* out_sims, void* n_scored, int q,
                                   int W, int kg, int kr, int B,
                                   void* stream) {
  const size_t smem = repro_descent_hop_smem_bytes(W, kg, kr, B);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        descent_hop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  descent_hop_kernel<<<q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(graph), static_cast<const int*>(rev),
      static_cast<const uint32_t*>(words), static_cast<const int*>(card),
      static_cast<const uint8_t*>(tomb), static_cast<const uint32_t*>(q_words),
      static_cast<const int*>(q_card), static_cast<const int*>(beam_ids),
      static_cast<const float*>(beam_sims), static_cast<int*>(out_ids),
      static_cast<float*>(out_sims), static_cast<int*>(n_scored), W, kg, kr,
      B);
  return static_cast<int>(cudaGetLastError());
}
