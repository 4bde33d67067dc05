// Streaming MaxSim scan: scores[b, n] for every query b against every
// document n of a corpus.
//
// Replaces the TPU kernel `maxsim_pallas` (src/repro/kernels/maxsim/
// maxsim.py, body `_maxsim_kernel`), with its int8 variant (`scales`).
// On the TPU the grid walks (B, N/bn, D/bd) in order and carries the
// running max in VMEM scratch across D tiles. Here blocks run in parallel
// in no order, so nothing carries between blocks: a block holds one query
// in shared memory and each of its warps walks all D vectors of one
// document, keeping the running max in registers (maxsim_common.cuh).
// Ragged N, D and Q are masked in the kernel, so the wrapper pads nothing.
// int8 documents load 8 codes per 8-byte load and multiply each by its
// vector's scale before the multiply-add, as the TPU body does.
//
// What bounds it on an H100: the f32 multiply-adds, 2*B*Q*N*D*d operations
// at 67 TFLOP/s on the CUDA cores (at ColPali width the corpus read is far
// smaller than that: N*D*d*2 bytes, or N*D*(d+4) for int8, at 3.35 TB/s).
// The design keeps the [B, N, Q, D] similarity tensor out of device memory
// entirely; blocks of one document tile for consecutive queries are
// adjacent in the grid (query index fastest), so a tile is read from
// device memory once per wave and from L2 by the other queries. Tensor
// cores (wgmma) and TMA pipelining are left for a later change.
#include "maxsim_common.cuh"

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
  const int tiles = (N + WARPS - 1) / WARPS;
  const dim3 grid(B, tiles < 65535 ? tiles : 65535);
  maxsim_scan_kernel<T><<<grid, THREADS, smem, stream>>>(
      q, qm, static_cast<const T*>(docs), scales, dm, dm_stride, out, Q, Qp,
      N, D, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace maxsim

// q [B,Q,d] f32, q_mask [B,Q] f32, docs [N,D,d] of docs_type (0 f32,
// 1 bf16, 2 int8 codes with scales [N,D] f32; scales is unused otherwise),
// doc_mask rows of D bytes (row stride doc_mask_stride: D, or 0 for one
// broadcast row), out [B,N] f32. Returns the launch's cudaError_t.
extern "C" int maxsim_scan_launch(const void* q, const void* q_mask,
                                  const void* docs, int docs_type,
                                  const void* scales, const void* doc_mask,
                                  long long doc_mask_stride, void* out, int B,
                                  int Q, int N, int D, int d, void* stream) {
  using namespace maxsim;
  const float* qf = static_cast<const float*>(q);
  const float* qmf = static_cast<const float*>(q_mask);
  const float* sc = static_cast<const float*>(scales);
  const uint8_t* dm = static_cast<const uint8_t*>(doc_mask);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t st = (int64_t)doc_mask_stride;
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
