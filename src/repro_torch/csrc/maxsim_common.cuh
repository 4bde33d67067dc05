// Shared device code of the MaxSim scan, double-buffered scan and
// gather-rerank kernels.
//
// One warp scores one (query, document) pair: the query's tokens sit in
// shared memory as f32, lanes stride over the document's vectors, each
// lane keeps a running max per query token in registers, and a warp
// shuffle reduces the lanes' maxima. The [Q, D] similarity block of a pair
// never leaves registers; only the pair's score is written.
//
// Documents are f32, bf16, or int8 codes with one f32 scale per vector.
// An int8 element enters the product as code * scale, rounded to f32 per
// element, which is what the TPU kernels compute (`docs.astype(f32) *
// scale`) and what the plain version's dequantised copy holds.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace maxsim {

constexpr float NEG = -1e30f;
constexpr int QT = 16;               // query tokens held in registers per pass
constexpr int WARPS = 8;             // warps per block, one document per warp
constexpr int THREADS = WARPS * 32;

// Document element types, as the launchers receive them.
enum DocType : int { DOC_F32 = 0, DOC_BF16 = 1, DOC_INT8 = 2 };

template <typename T>
constexpr bool kInt8 = std::is_same<T, int8_t>::value;

// A load from global memory through the read-only path, or from shared
// memory.
template <bool SMEM, typename V>
__device__ __forceinline__ V ld(const V* p) {
  if constexpr (SMEM) return *p;
  else return __ldg(p);
}

// Eight consecutive vector elements, widened to f32: two 16-byte loads for
// f32, one for bf16, one 8-byte load for int8 codes (the wrappers
// guarantee 16-byte aligned float rows and 8-byte aligned code rows).
template <bool SMEM>
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = ld<SMEM>(reinterpret_cast<const float4*>(p));
  const float4 b = ld<SMEM>(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <bool SMEM>
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 r = ld<SMEM>(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <bool SMEM>
__device__ __forceinline__ void load8(const int8_t* p, float v[8]) {
  const int2 r = ld<SMEM>(reinterpret_cast<const int2*>(p));
  const char4 a = *reinterpret_cast<const char4*>(&r.x);
  const char4 b = *reinterpret_cast<const char4*>(&r.y);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
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

// For QT query tokens qs [QT][d] (shared memory), the max over n vectors
// (row r at rows + r * row_stride elements) of <q_t, row_r>. A vector whose
// mask byte is 0 scores NEG, which is the initial value, so it is skipped.
// `scale` is the vectors' int8 scales (read only for int8 rows). SMEM says
// whether the rows are staged in shared memory or read from global memory.
// Every lane returns the warp-wide max.
template <typename T, bool SMEM>
__device__ __forceinline__ void warp_rows_max(
    const float* qs, const T* __restrict__ rows, int row_stride,
    const uint8_t* __restrict__ mask, const float* __restrict__ scale,
    int n, int d, float best[QT]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < QT; ++t) best[t] = NEG;
  for (int j = lane; j < n; j += 32) {
    if (!__ldg(mask + j)) continue;
    float s = 1.f;
    if constexpr (kInt8<T>) s = __ldg(scale + j);
    float acc[QT];
#pragma unroll
    for (int t = 0; t < QT; ++t) acc[t] = 0.f;
    const T* row = rows + (size_t)j * row_stride;
    for (int k = 0; k < d; k += 8) {
      float v[8];
      load8<SMEM>(row + k, v);
      if constexpr (kInt8<T>) {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] *= s;
      }
#pragma unroll
      for (int t = 0; t < QT; ++t) {
        const float4 a = *reinterpret_cast<const float4*>(qs + t * d + k);
        const float4 c = *reinterpret_cast<const float4*>(qs + t * d + k + 4);
        float x = acc[t];
        x = fmaf(a.x, v[0], x);
        x = fmaf(a.y, v[1], x);
        x = fmaf(a.z, v[2], x);
        x = fmaf(a.w, v[3], x);
        x = fmaf(c.x, v[4], x);
        x = fmaf(c.y, v[5], x);
        x = fmaf(c.z, v[6], x);
        x = fmaf(c.w, v[7], x);
        acc[t] = x;
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

// MaxSim of the query in shared memory against one document read from
// global memory: the sum over valid query tokens of the per-token max.
// CLAMP floors each valid token's max at NEG/2 (the scan's contract); the
// rerank sums the raw max, so a fully masked candidate scores Qv * NEG.
template <typename T, bool CLAMP>
__device__ __forceinline__ float warp_maxsim(const float* qs, const float* qm,
                                             int Qp, const T* doc,
                                             const uint8_t* mask,
                                             const float* scale, int D,
                                             int d) {
  float total = 0.f;
  for (int q0 = 0; q0 < Qp; q0 += QT) {
    float best[QT];
    warp_rows_max<T, false>(qs + (size_t)q0 * d, doc, d, mask, scale, D, d,
                            best);
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
