// Fused gather + exact MaxSim rerank: scores[b, l] of query b against its
// candidate document rows[b, l], for per-query candidate lists.
//
// Replaces the TPU kernel `maxsim_rerank_pallas` (src/repro/kernels/
// maxsim/maxsim.py, body `_rerank_kernel`), with its int8 variant
// (`scales`). There the candidate slot ids are scalar-prefetched and drive
// the BlockSpec index maps, so each grid step DMAs the chosen document
// tile (and its scales). Here each warp reads its own slot id from `rows`
// and walks that document's D vectors, and for int8 its D scales, straight
// from the corpus: no gathered [B, L, D, d] copy is ever written. The mask
// is read with a row stride, 0 for a broadcast [1, D] mask. There is no
// NEG/2 clamp: a fully masked candidate scores Qv * NEG, as in the
// reference.
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
                     const float* __restrict__ scales,
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
      const float s = warp_maxsim<T, false>(
          qs, qm, Qp, docs + n * D * d, dmask + n * dmask_stride,
          kInt8<T> ? scales + n * D : nullptr, D, d);
      if (lane == 0) out[(size_t)b * L + l] = s;
    }
  }
}

constexpr size_t RERANK_SMEM_MAX = 232448;  // opt-in shared memory per block

template <typename T>
int launch(const int32_t* rows, const float* q, const float* qm,
           const void* docs, const float* scales, const uint8_t* dm,
           int64_t dm_stride, float* out, int B, int L, int Q, int D, int d,
           cudaStream_t stream) {
  const int Qp = padded_q(Q);
  const size_t smem = query_smem_bytes(Qp, d);
  // a query block above the 48 KB default needs the opt-in maximum
  if (smem > RERANK_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        maxsim_rerank_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((L + WARPS - 1) / WARPS, B < 65535 ? B : 65535);
  maxsim_rerank_kernel<T><<<grid, THREADS, smem, stream>>>(
      rows, q, qm, static_cast<const T*>(docs), scales, dm, dm_stride, out,
      B, L, Q, Qp, D, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace maxsim

// rows [B,L] int32 in-range slot ids, q [B,Q,d] f32, q_mask [B,Q] f32,
// docs [N,D,d] of docs_type (0 f32, 1 bf16, 2 int8 codes with scales [N,D]
// f32; scales is unused otherwise), doc_mask rows of D bytes (row stride
// doc_mask_stride: D, or 0 for one broadcast row), out [B,L] f32.
// Returns the launch's cudaError_t.
extern "C" int maxsim_rerank_launch(const void* rows, const void* q,
                                    const void* q_mask, const void* docs,
                                    int docs_type, const void* scales,
                                    const void* doc_mask,
                                    long long doc_mask_stride, void* out,
                                    int B, int L, int Q, int D, int d,
                                    void* stream) {
  using namespace maxsim;
  const int32_t* r = static_cast<const int32_t*>(rows);
  const float* qf = static_cast<const float*>(q);
  const float* qmf = static_cast<const float*>(q_mask);
  const float* sc = static_cast<const float*>(scales);
  const uint8_t* dm = static_cast<const uint8_t*>(doc_mask);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t st = (int64_t)doc_mask_stride;
  switch (docs_type) {
    case DOC_F32:
      return launch<float>(r, qf, qmf, docs, sc, dm, st, o, B, L, Q, D, d, s);
    case DOC_BF16:
      return launch<__nv_bfloat16>(r, qf, qmf, docs, sc, dm, st, o, B, L, Q,
                                   D, d, s);
    case DOC_INT8:
      return launch<int8_t>(r, qf, qmf, docs, sc, dm, st, o, B, L, Q, D, d,
                            s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
