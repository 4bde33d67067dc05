// Streaming MaxSim scan: scores[b, n] for every query b against every
// document n of a corpus, with the NEG/2 floor per valid query token.
//
// Replaces the TPU kernel `maxsim_pallas` (src/repro/kernels/maxsim/
// maxsim.py:80, body `_maxsim_kernel`), with its int8 variant (`scales`,
// :105). On the TPU the grid walks (B, N/bn, D/bd) in order and carries
// the running max in VMEM scratch across D tiles. Here blocks run in
// parallel in no order, so nothing carries between blocks: a block owns
// whole documents and carries their running max itself.
//
// Two routes, chosen by `wg::tensor_route` (exported as
// `maxsim_scan_route`) from the document type, D and d alone (never by a
// failed launch):
//
// - tensor (bf16 documents or int8 codes, D >= 16, d of 32, 64 or 128):
//   the bf16 wgmma kernel of maxsim_wgmma.cuh, one block per SM over a
//   range of whole documents. Documents are the M side in 64-row tiles of
//   the flattened [N*D, d] rows, streamed through a 3-slot cp.async ring;
//   the packed VALID query tokens of a group of queries are the N side,
//   held in shared memory as a split-precision pair (q_hi + q_lo, bf16),
//   so each document tile is read once per group (one group holds the
//   main path's 32 queries) and masked query slots cost nothing. What
//   bounds it on an H100: the
//   two bf16 products per f32 multiply-add, 4*T*N*D*d operations for T
//   valid tokens at 989 TFLOP/s (the corpus read, N*D*d*2 bytes at 3.35
//   TB/s, is smaller at the main path's 320 tokens per batch).
// - warp (f32 documents, D < 16 such as the D = 1 IVF centroid scores,
//   or another d): one warp per (query, document) on the CUDA cores
//   (maxsim_common.cuh), the query in shared memory as f32, bound by the
//   f32 multiply-adds at 67 TFLOP/s. A 64-row tile of one vector would
//   waste 63/64 of a tensor-core product.
//
// Both routes opt in to the card's shared-memory maximum, and the launcher
// returns cudaErrorInvalidValue when a query does not fit. The wrappers
// take the route and the tensor route's token cap from this library
// (`maxsim_scan_route`, `maxsim_scan_token_cap`) and check a query's Q
// token slots against it (or `ops.warp_query_cap`) before the launch.
#include "maxsim_common.cuh"
#include "maxsim_wgmma.cuh"

namespace maxsim {

template <typename T>
__global__ void __launch_bounds__(THREADS)
maxsim_scan_kernel(const float* __restrict__ q, const float* __restrict__ qmask,
                   const T* __restrict__ docs, const float* __restrict__ scales,
                   const uint8_t* __restrict__ dmask, int64_t dmask_stride,
                   float* __restrict__ out, int Q, int Qp, int N, int D,
                   int d) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* qm = qs + (size_t)Qp * d;
  const int b = blockIdx.x;
  load_query(q, qmask, b, Q, Qp, d, qs, qm);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int64_t tile = blockIdx.y; tile * WARPS < N; tile += gridDim.y) {
    const int64_t n = tile * WARPS + warp;
    if (n >= N) continue;  // warp-uniform
    const float s = warp_maxsim<T, true>(
        qs, qm, Qp, docs + n * D * d, dmask + n * dmask_stride,
        kInt8<T> ? scales + n * D : nullptr, D, d);
    if (lane == 0) out[(size_t)b * N + n] = s;
  }
}

template <typename T>
int launch(const float* q, const float* qm, const void* docs,
           const float* scales, const uint8_t* dm, int64_t dm_stride,
           float* out, int B, int Q, int N, int D, int d,
           cudaStream_t stream) {
  const int Qp = padded_q(Q);
  const size_t smem = query_smem_bytes(Qp, d);
  if (smem > wg::SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        maxsim_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles = (N + WARPS - 1) / WARPS;
  const dim3 grid(B, tiles < 65535 ? tiles : 65535);
  maxsim_scan_kernel<T><<<grid, THREADS, smem, stream>>>(
      q, qm, static_cast<const T*>(docs), scales, dm, dm_stride, out, Q, Qp,
      N, D, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace maxsim

// The route a scan of docs_type (0 f32, 1 bf16, 2 int8 codes) with D
// vectors of dim d per document takes: 1 = tensor cores (wgmma), 0 = warp.
// The rule is `wg::tensor_route`, which the double-buffered scan and the
// rerank launchers apply too; the wrappers of all three ask it here.
extern "C" int maxsim_scan_route(int docs_type, int D, int d) {
  return wg::tensor_route(docs_type, D, d) ? 1 : 0;
}

// Tokens per query group (a multiple of 64) that the tensor route holds in
// shared memory at vector dim d.
extern "C" int maxsim_scan_token_cap(int docs_type, int d) {
  return wg::token_cap(d, docs_type == maxsim::DOC_INT8 ? 1 : 2);
}

// q [B,Q,d] f32, q_mask [B,Q] f32, docs [N,D,d] of docs_type (0 f32,
// 1 bf16, 2 int8 codes with scales [N,D] f32; scales is unused otherwise),
// doc_mask rows of D bytes (row stride doc_mask_stride: D, or 0 for one
// broadcast row), out [B,N] f32. The tensor route reads the query from
// the packed operand instead (`ops.scan_query_operand`): qpack [*, 2, d]
// bf16 (the valid tokens' q_hi, q_lo in query order), qstart/qcount [B]
// int32 (query b's first token and count) and TP, the tokens a group may
// hold; it is required there and must be null (TP 0) on the warp route.
// Returns the launch's cudaError_t.
extern "C" int maxsim_scan_launch(const void* q, const void* q_mask,
                                  const void* docs, int docs_type,
                                  const void* scales, const void* doc_mask,
                                  long long doc_mask_stride, void* out, int B,
                                  int Q, int N, int D, int d,
                                  const void* qpack, const void* qstart,
                                  const void* qcount, int TP, void* stream) {
  using namespace maxsim;
  const float* qf = static_cast<const float*>(q);
  const float* qmf = static_cast<const float*>(q_mask);
  const float* sc = static_cast<const float*>(scales);
  const uint8_t* dm = static_cast<const uint8_t*>(doc_mask);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t st = (int64_t)doc_mask_stride;
  if (wg::tensor_route(docs_type, D, d))
    return wg::launch_scan(qpack, qstart, qcount, B, TP, docs, docs_type, sc,
                           dm, st, o, N, D, d, s);
  if (qpack || TP) return static_cast<int>(cudaErrorInvalidValue);  // tensor
  switch (docs_type) {
    case DOC_F32:
      return launch<float>(qf, qmf, docs, sc, dm, st, o, B, Q, N, D, d, s);
    case DOC_BF16:
      return launch<__nv_bfloat16>(qf, qmf, docs, sc, dm, st, o, B, Q, N, D,
                                   d, s);
    case DOC_INT8:
      return launch<int8_t>(qf, qmf, docs, sc, dm, st, o, B, Q, N, D, d, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
