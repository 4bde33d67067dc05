// Shared device code of the MaxSim scan and gather-rerank kernels.
//
// One warp scores one (query, document) pair: the query's tokens sit in
// shared memory as f32, lanes stride over the document's D vectors, each
// lane keeps a running max per query token in registers, and a warp
// shuffle reduces the lanes' maxima. The [Q, D] similarity block of a pair
// never leaves registers; only the pair's score is written.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace maxsim {

constexpr float NEG = -1e30f;
constexpr int QT = 16;               // query tokens held in registers per pass
constexpr int WARPS = 8;             // warps per block, one document per warp
constexpr int THREADS = WARPS * 32;

// Eight consecutive vector elements, widened to f32 (one 16-byte load for
// bf16, two for f32; the wrapper guarantees 16-byte aligned rows).
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Copy query b's Q tokens (zero rows up to Qp) and its mask into shared
// memory, then synchronise the block.
__device__ __forceinline__ void load_query(const float* __restrict__ q,
                                           const float* __restrict__ qmask,
                                           int b, int Q, int Qp, int d,
                                           float* qs, float* qm) {
  for (int i = threadIdx.x; i < Qp * d; i += blockDim.x) {
    const int t = i / d;
    qs[i] = t < Q ? q[((size_t)b * Q + t) * d + (i - t * d)] : 0.f;
  }
  for (int t = threadIdx.x; t < Qp; t += blockDim.x)
    qm[t] = t < Q ? qmask[(size_t)b * Q + t] : 0.f;
  __syncthreads();
}

// For QT query tokens qs [QT][d], the max over one document's vectors of
// <q_t, doc_j>. A vector whose mask byte is 0 scores NEG, which is the
// initial value, so it is skipped. Every lane returns the warp-wide max.
template <typename T>
__device__ __forceinline__ void warp_doc_max(const float* qs,
                                             const T* __restrict__ doc,
                                             const uint8_t* __restrict__ mask,
                                             int D, int d, float best[QT]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < QT; ++t) best[t] = NEG;
  for (int j = lane; j < D; j += 32) {
    if (!mask[j]) continue;
    float acc[QT];
#pragma unroll
    for (int t = 0; t < QT; ++t) acc[t] = 0.f;
    const T* row = doc + (size_t)j * d;
    for (int k = 0; k < d; k += 8) {
      float v[8];
      load8(row + k, v);
#pragma unroll
      for (int t = 0; t < QT; ++t) {
        const float4 a = *reinterpret_cast<const float4*>(qs + t * d + k);
        const float4 c = *reinterpret_cast<const float4*>(qs + t * d + k + 4);
        float s = acc[t];
        s = fmaf(a.x, v[0], s);
        s = fmaf(a.y, v[1], s);
        s = fmaf(a.z, v[2], s);
        s = fmaf(a.w, v[3], s);
        s = fmaf(c.x, v[4], s);
        s = fmaf(c.y, v[5], s);
        s = fmaf(c.z, v[6], s);
        s = fmaf(c.w, v[7], s);
        acc[t] = s;
      }
    }
#pragma unroll
    for (int t = 0; t < QT; ++t) best[t] = fmaxf(best[t], acc[t]);
  }
#pragma unroll
  for (int t = 0; t < QT; ++t) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      best[t] = fmaxf(best[t], __shfl_xor_sync(0xffffffffu, best[t], off));
  }
}

// MaxSim of the query in shared memory against one document: the sum over
// valid query tokens of the per-token max. CLAMP floors each valid token's
// max at NEG/2 (the scan's contract); the rerank sums the raw max, so a
// fully masked candidate scores Qv * NEG.
template <typename T, bool CLAMP>
__device__ __forceinline__ float warp_maxsim(const float* qs, const float* qm,
                                             int Qp, const T* doc,
                                             const uint8_t* mask, int D,
                                             int d) {
  float total = 0.f;
  for (int q0 = 0; q0 < Qp; q0 += QT) {
    float best[QT];
    warp_doc_max<T>(qs + (size_t)q0 * d, doc, mask, D, d, best);
#pragma unroll
    for (int t = 0; t < QT; ++t)
      if (qm[q0 + t] > 0.f) total += CLAMP ? fmaxf(best[t], 0.5f * NEG) : best[t];
  }
  return total;
}

// Shared memory the scan and rerank kernels need for one query.
inline size_t query_smem_bytes(int Qp, int d) {
  return ((size_t)Qp * d + Qp) * sizeof(float);
}

inline int padded_q(int Q) { return (Q + QT - 1) / QT * QT; }

}  // namespace maxsim
