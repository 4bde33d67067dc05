// Fused training-free pooling at index time:
//   out[b] = (P @ (x[b] * m[b])) / max(P @ m[b], 1e-9), then an L2 renorm.
//
// Replaces the TPU kernel `pool_pallas` (src/repro/kernels/pooling/
// pooling.py, body `_pool_kernel`), whose grid walks (B, S/bs) and carries
// the numerator and denominator in VMEM scratch across S tiles. Here one
// block owns one (page b, output row o): its threads each own one of the d
// lanes and loop over all S tokens, accumulating P[o,s]*(m[b,s]*x[b,s,:])
// and P[o,s]*m[b,s] in f32 registers; the epilogue divides, then L2-
// renormalises with a warp-shuffle and shared-memory reduction. Pages may
// be strided (the visual tail of a [B, S_full, d] batch is read in place).
//
// What bounds it on an H100: device-memory bytes, one read of the pages
// (B*S*d*4) at 3.35 TB/s; the 2*B*n_out*S*d operations are far below the
// f32 rate. P stays dense here: the blocks of one page (output row fastest
// in the grid) re-read the page from L2, and P's structural zeros are
// multiplied through. Skipping them is a later change.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void pool_kernel(const float* __restrict__ x, int64_t x_stride,
                            const float* __restrict__ mask, int64_t m_stride,
                            const float* __restrict__ pm,
                            float* __restrict__ out, int B, int S, int d,
                            int n_out, int l2_norm) {
  __shared__ float red[32];
  const int o = blockIdx.x;
  const int t = threadIdx.x;
  const float* prow = pm + (size_t)o * S;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const float* xb = x + (size_t)b * x_stride;
    const float* mb = mask + (size_t)b * m_stride;
    float num = 0.f, den = 0.f;
    for (int s = 0; s < S; ++s) {
      const float p = prow[s];
      const float m = mb[s];
      den = fmaf(p, m, den);
      if (t < d) num = fmaf(p, xb[(size_t)s * d + t] * m, num);
    }
    float v = t < d ? num / fmaxf(den, 1e-9f) : 0.f;
    if (l2_norm) {
      float sq = v * v;
      for (int off = 16; off > 0; off >>= 1)
        sq += __shfl_xor_sync(0xffffffffu, sq, off);
      __syncthreads();  // red[] is free from the previous page
      if ((t & 31) == 0) red[t >> 5] = sq;
      __syncthreads();
      float tot = 0.f;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) tot += red[w];
      v = v / fmaxf(sqrtf(tot), 1e-9f);
    }
    if (t < d) out[((size_t)b * n_out + o) * d + t] = v;
  }
}

}  // namespace

// x: B pages of [S, d] f32 rows (page stride x_page_stride elements, rows
// contiguous), mask: B rows of S f32 (stride mask_page_stride), pool_mat
// [n_out, S] f32, out [B, n_out, d] f32. Returns the launch's cudaError_t.
extern "C" int pool_launch(const void* x, long long x_page_stride,
                           const void* mask, long long mask_page_stride,
                           const void* pool_mat, void* out, int B, int S,
                           int d, int n_out, int l2_norm, void* stream) {
  const int threads = (d + 31) / 32 * 32;
  const dim3 grid(n_out, B < 65535 ? B : 65535);
  pool_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), (int64_t)x_page_stride,
      static_cast<const float*>(mask), (int64_t)mask_page_stride,
      static_cast<const float*>(pool_mat), static_cast<float*>(out), B, S, d,
      n_out, l2_norm);
  return static_cast<int>(cudaGetLastError());
}
