// Cluster-KNN sweep: top-k GoldFinger-Jaccard database neighbours of every
// query row, for a batch of independent (query set, database set) pairs.
//
// Replaces the TPU kernel src/repro/kernels/goldfinger_knn/goldfinger_knn.py
// ::knn_pallas (body _knn_kernel), which C² build Step 2 reaches through
// core/local_knn.py::_pallas_group_knn -> ops.cluster_knn.
//
// Design. One block per (batch, query-row tile of TQ rows). The TPU's
// sequential database-block grid axis becomes a loop inside the block over
// database tiles of TD rows staged in shared memory:
//   1. stage the TQ query rows (words, cards, ids) once;
//   2. per database tile: stage TD rows, then all 256 threads score the
//      TQ x TD pairs -- intersection = sum over the W packed words of
//      __popc(a & b), an exact integer equal to the reference's int8
//      bit-plane product -- into a shared sims tile (PAD and self pairs -inf);
//   3. the owner thread of each query row walks that row of the tile in
//      ascending database column and inserts into its running top-k, kept
//      in shared memory ordered by (sim desc, column asc). Columns arrive in
//      ascending order, so a candidate enters only if its sim is strictly
//      greater than the current k-th: equal sims keep the earliest column,
//      which is what select_topk over [running | chunk] and lax.top_k give.
// Slots never filled stay -inf and come out as PAD ids.
//
// What bounds it: per batch of c rows ~ c^2 * W (AND + popcount) pairs of
// work against c * (4W + 8) bytes read and c * k * 8 written, i.e. at the
// main path's W = 32 about 64 popcount-word operations for every byte moved
// -- bound by integer operations, not memory. Shared-memory rows are padded
// to an odd word stride so that the 32 threads of a warp, which read 32
// different database rows at the same word, hit 32 different banks.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
goldfinger_knn_kernel(const uint32_t* __restrict__ q_words,
                      const int* __restrict__ q_card,
                      const int* __restrict__ q_ids,
                      const uint32_t* __restrict__ d_words,
                      const int* __restrict__ d_card,
                      const int* __restrict__ d_ids,
                      int* __restrict__ out_ids, float* __restrict__ out_sims,
                      int nq, int nd, int W, int k, int tq, int td) {
  extern __shared__ unsigned char smem_raw[];
  const int ws = (W & 1) ? W : W + 1;  // odd stride: conflict-free columns
  uint32_t* sq = reinterpret_cast<uint32_t*>(smem_raw);  // [tq][ws]
  uint32_t* sd = sq + tq * ws;                            // [td][ws]
  int* s_qcard = reinterpret_cast<int*>(sd + td * ws);    // [tq]
  int* s_qid = s_qcard + tq;                              // [tq]
  int* s_dcard = s_qid + tq;                              // [td]
  int* s_did = s_dcard + td;                              // [td]
  float* s_sim = reinterpret_cast<float*>(s_did + td);    // [tq][td + 1]
  float* top_sim = s_sim + tq * (td + 1);                 // [tq][k]
  int* top_id = reinterpret_cast<int*>(top_sim + tq * k); // [tq][k]

  const int tid = threadIdx.x;
  const int batch = blockIdx.y;
  const int row0 = blockIdx.x * tq;
  const long long qbase = static_cast<long long>(batch) * nq;
  const long long dbase = static_cast<long long>(batch) * nd;
  const float ninf = repro::neg_inf();

  for (int i = tid; i < tq * W; i += kThreads) {
    const int r = i / W, w = i - r * W;
    const int row = row0 + r;
    sq[r * ws + w] = row < nq ? q_words[(qbase + row) * W + w] : 0u;
  }
  for (int r = tid; r < tq; r += kThreads) {
    const int row = row0 + r;
    s_qcard[r] = row < nq ? q_card[qbase + row] : 0;
    s_qid[r] = row < nq ? q_ids[qbase + row] : repro::kPadId;
  }
  for (int i = tid; i < tq * k; i += kThreads) {
    top_sim[i] = ninf;
    top_id[i] = repro::kPadId;
  }

  for (int col0 = 0; col0 < nd; col0 += td) {
    __syncthreads();  // previous tile's owners are done with sd / s_sim
    for (int i = tid; i < td * W; i += kThreads) {
      const int r = i / W, w = i - r * W;
      const int col = col0 + r;
      sd[r * ws + w] = col < nd ? d_words[(dbase + col) * W + w] : 0u;
    }
    for (int r = tid; r < td; r += kThreads) {
      const int col = col0 + r;
      s_dcard[r] = col < nd ? d_card[dbase + col] : 0;
      s_did[r] = col < nd ? d_ids[dbase + col] : repro::kPadId;
    }
    __syncthreads();

    for (int p = tid; p < tq * td; p += kThreads) {
      const int qi = p / td, dj = p - qi * td;
      const int qid = s_qid[qi], did = s_did[dj];
      float sim = ninf;
      if (qid != repro::kPadId && did != repro::kPadId && qid != did) {
        const uint32_t* a = sq + qi * ws;
        const uint32_t* b = sd + dj * ws;
        int inter = 0;
        for (int w = 0; w < W; ++w) inter += __popc(a[w] & b[w]);
        sim = repro::jaccard_sim(inter, s_qcard[qi], s_dcard[dj]);
      }
      s_sim[qi * (td + 1) + dj] = sim;
    }
    __syncthreads();

    if (tid < tq) {
      float* ts = top_sim + tid * k;
      int* ti = top_id + tid * k;
      float tail = ts[k - 1];
      const float* row = s_sim + tid * (td + 1);
      for (int dj = 0; dj < td; ++dj) {
        const float s = row[dj];
        if (!(s > tail)) continue;  // equal sims keep the earlier column
        int pos = k - 1;
        while (pos > 0 && ts[pos - 1] < s) {
          ts[pos] = ts[pos - 1];
          ti[pos] = ti[pos - 1];
          --pos;
        }
        ts[pos] = s;
        ti[pos] = s_did[dj];
        tail = ts[k - 1];
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < tq * k; i += kThreads) {
    const int r = i / k, j = i - r * k;
    const int row = row0 + r;
    if (row >= nq) continue;
    const float s = top_sim[i];
    const long long o = (qbase + row) * k + j;
    out_sims[o] = s;
    out_ids[o] = s == ninf ? repro::kPadId : top_id[i];
  }
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

REPRO_EXPORT size_t repro_goldfinger_knn_smem_bytes(int W, int k, int tq,
                                                    int td) {
  const int ws = (W & 1) ? W : W + 1;
  return sizeof(uint32_t) * static_cast<size_t>(tq + td) * ws +
         sizeof(int) * static_cast<size_t>(2 * tq + 2 * td) +
         sizeof(float) * static_cast<size_t>(tq) * (td + 1) +
         (sizeof(float) + sizeof(int)) * static_cast<size_t>(tq) * k;
}

// q_* are [batches, nq, ...] and d_* are [batches, nd, ...], row-major and
// contiguous (words as uint32 bit patterns); outputs are [batches, nq, k].
// Launches on `stream` and returns cudaGetLastError() (0 on success).
REPRO_EXPORT int repro_goldfinger_knn(const void* q_words, const void* q_card,
                                      const void* q_ids, const void* d_words,
                                      const void* d_card, const void* d_ids,
                                      void* out_ids, void* out_sims,
                                      int batches, int nq, int nd, int W,
                                      int k, int tq, int td, void* stream) {
  const size_t smem = repro_goldfinger_knn_smem_bytes(W, k, tq, td);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        goldfinger_knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((nq + tq - 1) / tq, batches);
  goldfinger_knn_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q_words), static_cast<const int*>(q_card),
      static_cast<const int*>(q_ids), static_cast<const uint32_t*>(d_words),
      static_cast<const int*>(d_card), static_cast<const int*>(d_ids),
      static_cast<int*>(out_ids), static_cast<float*>(out_sims), nq, nd, W, k,
      tq, td);
  return static_cast<int>(cudaGetLastError());
}
