// Fused gather + exact MaxSim rerank: scores[b, l] of query b against its
// candidate document rows[b, l], for per-query candidate lists.
//
// Replaces the TPU kernel `maxsim_rerank_pallas` (src/repro/kernels/
// maxsim/maxsim.py, body `_rerank_kernel`). There the candidate slot ids
// are scalar-prefetched and drive the BlockSpec index maps, so each grid
// step DMAs the chosen document tile. Here each warp reads its own slot id
// from `rows` and walks that document's D vectors straight from the
// corpus: no gathered [B, L, D, d] copy is ever written. The mask is read
// with a row stride, 0 for a broadcast [1, D] mask. There is no NEG/2
// clamp: a fully masked candidate scores Qv * NEG, as in the reference.
//
// What bounds it on an H100: the f32 multiply-adds, 2*B*L*Q*D*d operations
// at 67 TFLOP/s (the candidate rows, L*D*d*2 bytes per query, are read
// once). Candidates of one query share a block, so the query is loaded to
// shared memory once per WARPS candidates.
#include "maxsim_common.cuh"

namespace maxsim {

template <typename T>
__global__ void __launch_bounds__(THREADS)
maxsim_rerank_kernel(const int32_t* __restrict__ rows,
                     const float* __restrict__ q,
                     const float* __restrict__ qmask,
                     const T* __restrict__ docs,
                     const uint8_t* __restrict__ dmask, int64_t dmask_stride,
                     float* __restrict__ out, int B, int L, int Q, int Qp,
                     int D, int d) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* qm = qs + (size_t)Qp * d;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t l = (int64_t)blockIdx.x * WARPS + warp;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    __syncthreads();  // every warp is done with the previous query
    load_query(q, qmask, b, Q, Qp, d, qs, qm);
    if (l < L) {
      const int64_t n = rows[(size_t)b * L + l];
      const float s = warp_maxsim<T, false>(qs, qm, Qp, docs + n * D * d,
                                            dmask + n * dmask_stride, D, d);
      if (lane == 0) out[(size_t)b * L + l] = s;
    }
  }
}

}  // namespace maxsim

// rows [B,L] int32 in-range slot ids, q [B,Q,d] f32, q_mask [B,Q] f32,
// docs [N,D,d] bf16 (docs_bf16=1) or f32, doc_mask rows of D bytes (row
// stride doc_mask_stride: D, or 0 for one broadcast row), out [B,L] f32.
// Returns the launch's cudaError_t.
extern "C" int maxsim_rerank_launch(const void* rows, const void* q,
                                    const void* q_mask, const void* docs,
                                    int docs_bf16, const void* doc_mask,
                                    long long doc_mask_stride, void* out,
                                    int B, int L, int Q, int D, int d,
                                    void* stream) {
  using namespace maxsim;
  const int Qp = padded_q(Q);
  const size_t smem = query_smem_bytes(Qp, d);
  const dim3 grid((L + WARPS - 1) / WARPS, B < 65535 ? B : 65535);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* r = static_cast<const int32_t*>(rows);
  const float* qf = static_cast<const float*>(q);
  const float* qmf = static_cast<const float*>(q_mask);
  const uint8_t* dm = static_cast<const uint8_t*>(doc_mask);
  float* o = static_cast<float*>(out);
  if (docs_bf16)
    maxsim_rerank_kernel<__nv_bfloat16><<<grid, THREADS, smem, s>>>(
        r, qf, qmf, static_cast<const __nv_bfloat16*>(docs), dm,
        (int64_t)doc_mask_stride, o, B, L, Q, Qp, D, d);
  else
    maxsim_rerank_kernel<float><<<grid, THREADS, smem, s>>>(
        r, qf, qmf, static_cast<const float*>(docs), dm,
        (int64_t)doc_mask_stride, o, B, L, Q, Qp, D, d);
  return static_cast<int>(cudaGetLastError());
}
