// The descent hop's lanes, suppression and selection, shared by the two
// hop kernels (descent_hop.cu: fingerprints read straight from global
// memory; descent_hop_dma.cu: fingerprints gathered by cp.async into a
// shared-memory ring). Everything here decides ids and ranks, never how a
// fingerprint row reaches the scorer, so the two kernels agree bit for bit.
//
// Lanes are [beam | fwd | rev] in the reference's column order: B beam
// lanes, then the C = B * (kg + kr) candidate lanes (forward neighbours of
// every beam lane, then reverse ones).
#pragma once

#include "common.cuh"

namespace repro {
namespace hop {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Best {
  float sim;
  int col;
};

// (sim desc, col asc): true when a ranks before b.
__device__ __forceinline__ bool better(const Best& a, const Best& b) {
  return a.sim > b.sim || (a.sim == b.sim && a.col < b.col);
}

__device__ __forceinline__ Best warp_best(Best v) {
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.sim = __shfl_down_sync(0xffffffffu, v.sim, off);
    o.col = __shfl_down_sync(0xffffffffu, v.col, off);
    if (better(o, v)) v = o;
  }
  return v;
}

// Shared-memory scratch of select_beam: per-warp partials and two flags.
struct SelectScratch {
  float sim[kWarps];
  int col[kWarps];
  int win;
  int done;
};

// One query's beam into shared memory; lanes naming tombstoned rows drop to
// PAD / -inf, so a dead beam entry contributes no candidates.
__device__ __forceinline__ void stage_beam(const int* beam_ids,
                                           const float* beam_sims,
                                           const uint8_t* tomb, int B,
                                           int* s_id, float* s_sim) {
  for (int b = threadIdx.x; b < B; b += kThreads) {
    int id = beam_ids[b];
    float s = beam_sims[b];
    if (id != kPadId && tomb[id]) {
      id = kPadId;
      s = neg_inf();
    }
    s_id[b] = id;
    s_sim[b] = s;
  }
}

// Candidate lane c in [0, C) of a staged beam: PAD under a PAD beam lane,
// tombstoned ids turned to PAD. The tombstone flag is read per id from
// global memory (staging the column would cap the table's rows).
__device__ __forceinline__ int candidate_id(const int* __restrict__ graph,
                                            const int* __restrict__ rev,
                                            const uint8_t* __restrict__ tomb,
                                            const int* s_beam, int c, int B,
                                            int kg, int kr) {
  const int n_fwd = B * kg;
  int id;
  if (c < n_fwd) {
    const int b = c / kg;
    const int bid = s_beam[b];
    id = bid == kPadId
             ? kPadId
             : graph[static_cast<long long>(bid) * kg + (c - b * kg)];
  } else {
    const int cr = c - n_fwd;
    const int b = cr / kr;
    const int bid = s_beam[b];
    id = bid == kPadId
             ? kPadId
             : rev[static_cast<long long>(bid) * kr + (cr - b * kr)];
  }
  if (id != kPadId && tomb[id]) id = kPadId;
  return id;
}

// True when a candidate lane must be scored: not PAD and not already in
// the beam. Decided from ids alone, before any fingerprint is touched.
__device__ __forceinline__ bool survives(int id, const int* s_beam, int B) {
  bool need = id != kPadId;
  for (int b = 0; need && b < B; ++b) need = s_beam[b] != id;
  return need;
}

// The new beam of one query from its L = B + C staged lanes: B rounds of a
// block-wide (max sim, min column) reduction, retiring every lane that
// carries the round's winning id -- exactly select_topk(dedup_ids=True).
// Once the best remaining sim is -inf every later round is too, and the
// rest of the beam is PAD. Every thread of the block must call it; it
// returns with the block synchronised.
__device__ inline void select_beam(int* s_id, float* s_sim, int L, int B,
                                   int* out_ids, float* out_sims,
                                   SelectScratch* scr) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float ninf = neg_inf();
  if (tid == 0) scr->done = 0;
  __syncthreads();
  for (int r = 0; r < B; ++r) {
    Best best{ninf, 0x7fffffff};
    for (int l = tid; l < L; l += kThreads) {
      const Best v{s_sim[l], l};
      if (better(v, best)) best = v;
    }
    best = warp_best(best);
    if (lane == 0) {
      scr->sim[warp] = best.sim;
      scr->col[warp] = best.col;
    }
    __syncthreads();
    if (warp == 0) {
      Best v = lane < kWarps ? Best{scr->sim[lane], scr->col[lane]}
                             : Best{ninf, 0x7fffffff};
      v = warp_best(v);
      if (lane == 0) {
        if (v.sim == ninf) {
          for (int j = r; j < B; ++j) {
            out_ids[j] = kPadId;
            out_sims[j] = ninf;
          }
          scr->done = 1;
        } else {
          const int win = s_id[v.col];
          out_ids[r] = win;
          out_sims[r] = v.sim;
          scr->win = win;
        }
      }
    }
    __syncthreads();
    if (scr->done) break;  // uniform across the block
    const int win = scr->win;
    for (int l = tid; l < L; l += kThreads)
      if (s_id[l] == win) s_sim[l] = ninf;
    __syncthreads();
  }
  __syncthreads();  // every thread has read scr before a next call resets it
}

}  // namespace hop
}  // namespace repro
