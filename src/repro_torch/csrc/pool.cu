// Fused training-free pooling at index time:
//   out[b] = (P @ (x[b] * m[b])) / max(P @ m[b], 1e-9), then an L2 renorm.
//
// Replaces the TPU kernel `pool_pallas` (src/repro/kernels/pooling/
// pooling.py:54, body `_pool_kernel`), whose grid walks (B, S/bs) and
// carries the numerator and denominator in VMEM scratch across S tiles.
// Here one block owns one page and carries both in registers and shared
// memory across its own loop over S tiles.
//
// What bounds it on an H100: device-memory bytes, one read of the pages
// (B*S*d*4) at 3.35 TB/s; the product, 2*B*nnz(P)*d operations with P's
// zeros skipped (2*B*n_out*S*d dense), takes less at 67 TFLOP/s f32 (TF32
// or bf16 tensor cores would break the 1e-5 tolerance against the f32
// plain version). The design:
//
// - each page is read from device memory exactly once, streamed in tiles
//   of ST tokens through a STAGES-slot cp.async ring (three tiles in
//   flight while one is summed) together with the mask and P's [rows, ST]
//   tile (P stays in L2 across the pages);
// - thread (rg, quad) holds a register block of RPT consecutive output
//   rows x 4 lanes of d: rows rg*RPT .. rg*RPT+RPT-1, lanes 4*quad ..
//   4*quad+3. Per token it reads the page's 4 lanes once (one 16-byte
//   shared load, masked) and P four tokens at a time, and does 4*RPT
//   multiply-adds;
// - P's structural zeros are skipped: a row group sums only the tokens
//   between its rows' first and last nonzero (ColPali's row-mean + conv1d
//   rows span 3 of 32 grid rows, so a group of 5 rows reads ~7/32 of the
//   tokens); a zero weight adds nothing to a finite page's sums;
// - the denominator P @ m and each row's nonzero span are computed once
//   per (page, row) by a warp in the prologue, the L2 renorm by a warp per
//   row over the finished rows.
// Pages may be strided (the visual tail of a [B, S_full, d] batch is read
// in place).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ST = 32;          // tokens per S tile
constexpr int STAGES = 4;       // cp.async ring: 3 tiles in flight
constexpr size_t SMEM_MAX = 232448;

__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

// Shared memory layout (floats): STAGES slots of {x [ST][d], m [ST],
// P [RPP][ST]}, then den [RPP] and each row's nonzero span (2 ints per
// row). The finished rows [RPP][d] reuse the ring.
struct Layout {
  int x, m, p, slot, den, span, total;
  __host__ __device__ Layout(int d, int rpp)
      : x(0), m(ST * d), p(m + ST), slot(p + rpp * ST),
        den(STAGES * slot > rpp * d ? STAGES * slot : rpp * d),
        span(den + rpp), total(span + 2 * rpp) {}
};

// x: pages at x + b*x_stride, rows of d contiguous f32; mask rows of S4
// floats (zero past S); pm [n_out][S4] (zero past S). Rows of one pass:
// o0 + rg*RPT + k for k < RPT.
template <int RPT>
__global__ void __launch_bounds__(THREADS)
pool_kernel(const float* __restrict__ x, int64_t x_stride,
            const float* __restrict__ mask, const float* __restrict__ pm,
            float* __restrict__ out, int S, int S4, int d, int n_out,
            int l2_norm) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int quads = d / 4;
  const int RG = THREADS / quads;
  const int rpp = RG * RPT;
  const Layout L(d, rpp);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad = tid % quads, rg = tid / quads;
  const bool active = rg < RG;
  const int b = blockIdx.x;
  const float* xb = x + (size_t)b * x_stride;
  const float* mb = mask + (size_t)b * S4;
  const int ntiles = (S + ST - 1) / ST;

  for (int o0 = 0; o0 < n_out; o0 += rpp) {
    // issue the copies of tile t (if any) into ring slot t % STAGES and
    // commit them as one group
    auto load = [&](int t) {
      float* s = sm + (t % STAGES) * L.slot;
      const int s0 = t * ST;
      for (int i = tid; t < ntiles && i < ST * quads; i += THREADS) {
        const int r = i / quads, c = i - r * quads;
        const bool in = s0 + r < S;
        cp16(s + L.x + r * d + 4 * c,
             xb + (size_t)(in ? s0 + r : 0) * d + 4 * c, in ? 16 : 0);
      }
      for (int i = tid; t < ntiles && i < ST / 4 + rpp * (ST / 4);
           i += THREADS) {
        if (i < ST / 4) {
          const bool in = s0 + 4 * i < S4;
          cp16(s + L.m + 4 * i, mb + (in ? s0 + 4 * i : 0), in ? 16 : 0);
        } else {
          const int j = i - ST / 4, r = j / (ST / 4), c = j - r * (ST / 4);
          const int o = o0 + r;
          const bool in = o < n_out && s0 + 4 * c < S4;
          cp16(s + L.p + r * ST + 4 * c,
               pm + (in ? (size_t)o * S4 + s0 + 4 * c : 0), in ? 16 : 0);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };
    for (int t = 0; t < STAGES - 1; ++t) load(t);
    // the denominators of this pass's rows and their nonzero spans
    // [lo, hi) of tokens, once per (page, row)
    int* span = reinterpret_cast<int*>(sm + L.span);
    for (int r = warp; r < rpp; r += THREADS / 32) {
      const int o = o0 + r;
      float den = 0.f;
      int lo = S, hi = 0;
      if (o < n_out) {
        const float4* prow = reinterpret_cast<const float4*>(pm + (size_t)o *
                                                             S4);
        const float4* mrow = reinterpret_cast<const float4*>(mb);
#pragma unroll 4
        for (int s = lane; s < S4 / 4; s += 32) {   // independent loads
          const float4 p = __ldg(prow + s), mv = __ldg(mrow + s);
          const float pv[4] = {p.x, p.y, p.z, p.w};
          const float mm[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            den = fmaf(pv[u], mm[u], den);
            if (pv[u] != 0.f) {
              lo = min(lo, 4 * s + u);
              hi = 4 * s + u + 1;
            }
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        den += __shfl_xor_sync(0xffffffffu, den, off);
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      }
      if (lane == 0) {
        sm[L.den + r] = den;
        span[2 * r] = lo;
        span[2 * r + 1] = hi;
      }
    }
    __syncthreads();
    // this row group's tokens, in whole 4-token steps
    int glo = S, ghi = 0;
    for (int k = 0; active && k < RPT; ++k) {
      glo = min(glo, span[2 * (rg * RPT + k)]);
      ghi = max(ghi, span[2 * (rg * RPT + k) + 1]);
    }
    glo = glo / 4 * 4;
    ghi = (ghi + 3) / 4 * 4;

    float4 acc[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = 0; t < ntiles; ++t) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
      __syncthreads();          // tile t landed; tile t - 1 is summed
      load(t + STAGES - 1);     // into tile t - 1's slot
      const float* s = sm + (t % STAGES) * L.slot;
      const int jlo = max(glo - t * ST, 0), jhi = min(ghi - t * ST, ST);
      if (active) {
#pragma unroll 2
        for (int j = jlo; j < jhi; j += 4) {
          const float4 mv = *reinterpret_cast<const float4*>(s + L.m + j);
          const float mj[4] = {mv.x, mv.y, mv.z, mv.w};
          float4 xv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            xv[u] = *reinterpret_cast<const float4*>(s + L.x + (j + u) * d +
                                                     4 * quad);
            xv[u].x *= mj[u]; xv[u].y *= mj[u];
            xv[u].z *= mj[u]; xv[u].w *= mj[u];
          }
#pragma unroll
          for (int k = 0; k < RPT; ++k) {
            const float4 p = *reinterpret_cast<const float4*>(
                s + L.p + (rg * RPT + k) * ST + j);
            const float pj[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              acc[k].x = fmaf(pj[u], xv[u].x, acc[k].x);
              acc[k].y = fmaf(pj[u], xv[u].y, acc[k].y);
              acc[k].z = fmaf(pj[u], xv[u].z, acc[k].z);
              acc[k].w = fmaf(pj[u], xv[u].w, acc[k].w);
            }
          }
        }
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::);   // the empty tail groups
    __syncthreads();

    // divide, stage the finished rows in the ring, renormalise per row
    if (active) {
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int r = rg * RPT + k;
        const float inv = 1.f / fmaxf(sm[L.den + r], 1e-9f);
        float4 v = acc[k];
        v.x *= inv; v.y *= inv; v.z *= inv; v.w *= inv;
        *reinterpret_cast<float4*>(sm + r * d + 4 * quad) = v;
      }
    }
    __syncthreads();
    for (int r = warp; r < rpp; r += THREADS / 32) {
      const int o = o0 + r;
      if (o >= n_out) continue;                      // warp-uniform
      const float* row = sm + r * d;
      float scale = 1.f;
      if (l2_norm) {
        float sq = 0.f;
        for (int c = lane; c < d; c += 32) sq = fmaf(row[c], row[c], sq);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sq += __shfl_xor_sync(0xffffffffu, sq, off);
        scale = 1.f / fmaxf(sqrtf(sq), 1e-9f);
      }
      float* ob = out + ((size_t)b * n_out + o) * d;
      for (int c = lane; c < d; c += 32) ob[c] = row[c] * scale;
    }
    __syncthreads();              // the ring is free for the next pass
  }
}

template <int RPT>
int launch(const float* x, int64_t x_stride, const float* mask,
           const float* pm, float* out, int B, int S, int S4, int d,
           int n_out, int l2_norm, cudaStream_t stream) {
  const int rpp = (THREADS / (d / 4)) * RPT;
  const size_t smem = (size_t)Layout(d, rpp).total * sizeof(float);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pool_kernel<RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pool_kernel<RPT><<<B, THREADS, smem, stream>>>(x, x_stride, mask, pm, out,
                                                 S, S4, d, n_out, l2_norm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: B pages of [S, d] f32 rows (page stride x_page_stride elements, rows
// contiguous; 16-byte aligned, d % 4 == 0, d <= 1024), mask: B rows of S4
// f32 (S4 = S rounded up to a multiple of 4, zero past S), pool_mat
// [n_out, S4] f32 (zero past S), out [B, n_out, d] f32. Returns the
// launch's cudaError_t.
extern "C" int pool_launch(const void* x, long long x_page_stride,
                           const void* mask, const void* pool_mat, void* out,
                           int B, int S, int S4, int d, int n_out,
                           int l2_norm, void* stream) {
  if (d % 4 || d > 4 * THREADS || S4 % 4 || S4 < S || x_page_stride % 4 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* mf = static_cast<const float*>(mask);
  const auto* pf = static_cast<const float*>(pool_mat);
  auto* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rg = THREADS / (d / 4);
  int rpt = (n_out + rg - 1) / rg;                   // rows per thread
  if (rpt > 8) rpt = 8;                              // more rows: passes
  switch (rpt) {
#define POOL_CASE(R)                                                        \
  case R:                                                                   \
    return launch<R>(xf, x_page_stride, mf, pf, of, B, S, S4, d, n_out,     \
                     l2_norm, s);
    POOL_CASE(1) POOL_CASE(2) POOL_CASE(3) POOL_CASE(4)
    POOL_CASE(5) POOL_CASE(6) POOL_CASE(7) POOL_CASE(8)
#undef POOL_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
