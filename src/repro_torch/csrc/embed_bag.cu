// EmbeddingBag: out[b, :] = sum_j w[b, j] * f32(table[idx[b, j], :]),
// accumulated in j order from zero.
//
// Replaces the TPU kernel `embed_bag_pallas` (src/repro/kernels/embed_bag/
// embed_bag.py, body `_bag_kernel`). There the indices and weights are
// scalar-prefetched into SMEM, the grid walks (B, L) in order, and each
// step's BlockSpec index map picks the table row the next DMA fetches,
// accumulating into the revisited output block. Here blocks run in
// parallel, so the sequential L axis becomes a loop inside the block: a
// block owns one or more bags (one per threadIdx.y) and one tile of d
// (threadIdx.x over d, VEC elements per thread). Each bag's indices and
// weights are staged once into shared memory, in chunks, and every thread
// then walks j = 0..L-1 keeping its VEC sums in f32 registers. Rows load as
// 16 bytes per thread (4 f32 or 8 bf16/f16) where the row width allows.
//
// Every slot is read and adds w * row, zero-weight slots (padding, entries
// outside `valid`) included, as the TPU kernel does: the op points a padded
// slot at its clamped id, so a non-finite value in a row under a zero-weight
// slot makes that bag's column NaN (0 * inf), as in the reference. In the
// op's usual call every padded slot reads the same clamped row, which stays
// in cache.
//
// What bounds it on an H100: device-memory bytes, the distinct table rows
// the slots point at (256-512 B each; every slot's row counts, padded ones
// too) at 3.35 TB/s; the 2*B*L*d operations are
// far below the f32 rate. The j loop is unrolled by UNROLL so that many
// row loads are in flight per thread before their sums, which keep the j
// order.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;        // threads per block (x * y)
constexpr int STAGE = 2048;         // staged (index, weight) pairs per block
constexpr int UNROLL = 4;

enum TableType : int { TAB_F32 = 0, TAB_BF16 = 1, TAB_F16 = 2 };

template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* p, float v[VEC]);

template <>
__device__ __forceinline__ void load_row<float, 4>(const float* p,
                                                   float v[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

template <>
__device__ __forceinline__ void load_row<__nv_bfloat16, 8>(
    const __nv_bfloat16* p, float v[8]) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <>
__device__ __forceinline__ void load_row<__half, 8>(const __half* p,
                                                    float v[8]) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const __half2* h = reinterpret_cast<const __half2*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// One element per thread: any row width, any alignment.
template <>
__device__ __forceinline__ void load_row<float, 1>(const float* p,
                                                   float v[1]) {
  v[0] = __ldg(p);
}
template <>
__device__ __forceinline__ void load_row<__nv_bfloat16, 1>(
    const __nv_bfloat16* p, float v[1]) {
  v[0] = to_f32(p[0]);
}
template <>
__device__ __forceinline__ void load_row<__half, 1>(const __half* p,
                                                    float v[1]) {
  v[0] = to_f32(p[0]);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
embed_bag_kernel(const T* __restrict__ table, const int32_t* __restrict__ idx,
                 const float* __restrict__ w, float* __restrict__ out, int B,
                 int L, int d) {
  __shared__ int32_t s_idx[STAGE];
  __shared__ float s_w[STAGE];
  const int chunk = STAGE / blockDim.y;            // staged slots per bag
  const int bag = blockIdx.x * blockDim.y + threadIdx.y;
  const int col = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  const bool live = bag < B;
  const bool mine = live && col < d;
  int32_t* my_idx = s_idx + threadIdx.y * chunk;
  float* my_w = s_w + threadIdx.y * chunk;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < L; j0 += chunk) {
    const int n = min(chunk, L - j0);
    __syncthreads();                               // previous chunk consumed
    if (live) {
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        my_idx[j] = idx[(size_t)bag * L + j0 + j];
        my_w[j] = w[(size_t)bag * L + j0 + j];
      }
    }
    __syncthreads();
    if (!mine) continue;
    int j = 0;
    for (; j + UNROLL <= n; j += UNROLL) {
      float v[UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        load_row<T, VEC>(table + (size_t)my_idx[j + u] * d + col, v[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float wu = my_w[j + u];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = fmaf(wu, v[u][i], acc[i]);
      }
    }
    for (; j < n; ++j) {
      const float wj = my_w[j];
      float v[VEC];
      load_row<T, VEC>(table + (size_t)my_idx[j] * d + col, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(wj, v[i], acc[i]);
    }
  }
  if (!mine) return;
  float* o = out + (size_t)bag * d + col;
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2],
                                                acc[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = acc[i];
  }
}

template <typename T, int VEC>
int launch(const void* table, const int32_t* idx, const float* w, float* out,
           int B, int L, int d, cudaStream_t stream) {
  // threads per bag: enough lanes to cover d (a power of two, at most the
  // block), the rest of the block's threads take further bags
  const int lanes = (d + VEC - 1) / VEC;
  int tx = 1;
  while (tx < lanes && tx < THREADS) tx <<= 1;
  const int ty = THREADS / tx;
  const int tiles = (lanes + tx - 1) / tx;
  const dim3 block(tx, ty);
  const dim3 grid((B + ty - 1) / ty, tiles);
  embed_bag_kernel<T, VEC><<<grid, block, 0, stream>>>(
      static_cast<const T*>(table), idx, w, out, B, L, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int WIDE>
int dispatch(const void* table, const int32_t* idx, const float* w,
             float* out, int B, int L, int d, cudaStream_t stream) {
  // 16-byte row loads need the row width and the base to be 16-byte aligned
  const bool wide = d % WIDE == 0 &&
                    reinterpret_cast<uintptr_t>(table) % 16 == 0;
  return wide ? launch<T, WIDE>(table, idx, w, out, B, L, d, stream)
              : launch<T, 1>(table, idx, w, out, B, L, d, stream);
}

}  // namespace

// table [V, d] of table_type (0 f32, 1 bf16, 2 f16), idx [B, L] int32 in
// [0, V), w [B, L] f32, out [B, d] f32, all contiguous. Returns the
// launch's cudaError_t.
extern "C" int embed_bag_launch(const void* table, int table_type,
                                const void* idx, const void* w, void* out,
                                int B, int L, int d, void* stream) {
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (table_type) {
    case TAB_F32:
      return dispatch<float, 4>(table, ix, wf, o, B, L, d, s);
    case TAB_BF16:
      return dispatch<__nv_bfloat16, 8>(table, ix, wf, o, B, L, d, s);
    case TAB_F16:
      return dispatch<__half, 8>(table, ix, wf, o, B, L, d, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
