// Fused gather + exact MaxSim rerank: scores[b, l] of query b against its
// candidate document rows[b, l], for per-query candidate lists.
//
// Replaces the TPU kernel `maxsim_rerank_pallas` (src/repro/kernels/
// maxsim/maxsim.py:270, body `_rerank_kernel`), with its int8 variant
// (`scales`, :312). There the candidate slot ids are scalar-prefetched and
// drive the BlockSpec index maps (:303-308), so each grid step DMAs the
// chosen document tile (and its scales), and the per-token running max
// carries across a candidate's D tiles in VMEM scratch. There is no NEG/2
// clamp: a fully masked candidate scores Qv * NEG, as in the reference.
//
// Two routes, by the scan's rule `wg::tensor_route` (maxsim_wgmma.cuh;
// the wrapper asks it of the scan library as `maxsim_scan_route`):
//
// - tensor (bf16 documents or int8 codes, D >= 16, d of 32, 64 or 128):
//   `rerank_wgmma_kernel` below, one warpgroup per block over one query
//   and up to CB_MAX of its candidates. A candidate's D rows are the M
//   side of bf16 wgmma in 64-row tiles; the block reads the slot id from
//   `rows[b, l]` itself (the index map's part) and copies each tile
//   straight from the corpus into a 4-slot swizzled `cp.async` ring
//   (`wg::load_tile`), so no gathered copy is written and the copies of
//   the next three tiles are in flight while one is on the tensor cores.
//   The N side is the query's VALID tokens from the packed operand
//   (`ops.scan_query_operand`), 16 per pass as 16 q_hi + 16 q_lo rows: a
//   m64n32k16 product, not the scan's n128, since the main path's
//   queries hold 10 valid tokens; a query with more takes one pass per
//   16 tokens. Each thread keeps the running max of its 4 token columns
//   over a candidate's tiles in registers (masked rows and rows past D
//   score NEG; the int8 scale multiplies after the product); at the
//   candidate's last tile the 4 warps' maxima meet in shared memory and
//   warp 0 sums the valid tokens.
//   What bounds it on an H100: device-memory bytes, the candidates' rows
//   at 3.35 TB/s (D*d*2 bytes a candidate, D*(d+4) for int8 codes and
//   scales; candidates shared by several queries of a batch can come
//   from L2); the split product, 4*Qv*D*d operations a candidate at 989
//   TFLOP/s, is far below that.
// - warp (f32 documents, D < 16, another d): `maxsim_rerank_kernel`, one
//   warp per (query, candidate) walking the candidate's D vectors with
//   f32 FMAs on the CUDA cores (maxsim_common.cuh), the query in shared
//   memory, bound by the f32 multiply-adds at 67 TFLOP/s.
//
// Both routes read the mask with a row stride, 0 for a broadcast [1, D]
// mask, and mask ragged D themselves.
#include "maxsim_common.cuh"
#include "maxsim_wgmma.cuh"

namespace maxsim {

// ---------------------------------------------------------------------------
// warp route
// ---------------------------------------------------------------------------

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

template <typename T>
int launch(const int32_t* rows, const float* q, const float* qm,
           const void* docs, const float* scales, const uint8_t* dm,
           int64_t dm_stride, float* out, int B, int L, int Q, int D, int d,
           cudaStream_t stream) {
  const int Qp = padded_q(Q);
  const size_t smem = query_smem_bytes(Qp, d);
  // a query block above the 48 KB default needs the opt-in maximum
  if (smem > wg::SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
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

// ---------------------------------------------------------------------------
// tensor route
// ---------------------------------------------------------------------------

namespace rr {

constexpr int NT = 128;          // threads: one warpgroup
constexpr int TOK = 16;          // query tokens per pass
constexpr int BR = 2 * TOK;      // operand rows: q_hi then q_lo (n32)
constexpr int STAGES = 4;        // cp.async ring of candidate tiles
constexpr int CB_MAX = 64;       // candidates per block at most
constexpr int TILES = 128;       // tiles a block aims to stream

// Shared memory at vector dim d and document element size esize.
inline size_t smem_bytes(int d, int esize) {
  const int dp = wg::padded_d(d);
  size_t b = (size_t)BR * dp * 2;                        // query operand
  b += esize == 2 ? (size_t)STAGES * wg::TM * dp * 2     // bf16 tile ring
                  : (size_t)STAGES * wg::TM * d          // raw int8 ring
                        + (size_t)wg::TM * dp * 2;       // int8 -> bf16
  b += 4 * TOK * 4 + CB_MAX * 4;             // warp maxima, candidate ids
  return b + 1024;                           // atom alignment
}

// acc[16] += A[64 x 16] . B[32 x 16]^T, both bf16 K-major in shared
// memory (the swizzled layout of maxsim_wgmma.cuh).
__device__ __forceinline__ void wgmma_m64n32k16(float (&c)[16], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]), "+f"(c[4]),
        "+f"(c[5]), "+f"(c[6]), "+f"(c[7]), "+f"(c[8]), "+f"(c[9]),
        "+f"(c[10]), "+f"(c[11]), "+f"(c[12]), "+f"(c[13]), "+f"(c[14]),
        "+f"(c[15])
      : "l"(da), "l"(db), "r"(1));
}

}  // namespace rr

// Scores of query blockIdx.x against its candidates l0 .. l0 + cb - 1
// (l0 = blockIdx.y * cb). qpack/qstart/qcount as the scan's tensor route
// takes them; rows [B, L] in-range slot ids.
template <bool INT8, int DIM>
__global__ void __launch_bounds__(rr::NT)
rerank_wgmma_kernel(const int32_t* __restrict__ rows,
                    const __nv_bfloat16* __restrict__ qpack,
                    const int* __restrict__ qstart,
                    const int* __restrict__ qcount,
                    const void* __restrict__ docs,
                    const float* __restrict__ scales,
                    const uint8_t* __restrict__ dmask, int64_t dmask_stride,
                    float* __restrict__ out, int L, int D, int cb) {
  using rr::BR;
  using rr::NT;
  using rr::STAGES;
  using rr::TOK;
  using wg::TM;
  constexpr int KS = DIM / 16;
  constexpr int DP = (DIM + 63) / 64 * 64;
  constexpr int ROW = DIM * (INT8 ? 1 : 2);                // bytes per row
  constexpr int slot_bytes = INT8 ? TM * DIM : TM * DP * 2;
  extern __shared__ __align__(1024) char smem_raw[];
  // the swizzle pattern follows address bits 4-9: atoms start 1024-aligned
  const uint32_t pad = (1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023;
  char* bsm = smem_raw + pad;                              // query operand
  char* ring = bsm + BR * DP * 2;                          // tile ring
  char* conv = ring + STAGES * slot_bytes;                 // int8 -> bf16
  float* red = reinterpret_cast<float*>(conv + (INT8 ? TM * DP * 2 : 0));
  int* cand = reinterpret_cast<int*>(red + 4 * TOK);       // slot ids

  const int b = blockIdx.x;
  const int l0 = blockIdx.y * cb;
  const int nc = L - l0 < cb ? L - l0 : cb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wrow = warp * 16;               // this warp's rows in a tile
  float* outb = out + (size_t)b * L + l0;
  const int t0 = qstart[b], cnt = qcount[b];
  if (cnt == 0) {                            // no valid token: sums of none
    for (int i = tid; i < nc; i += NT) outb[i] = 0.f;
    return;
  }
  for (int i = tid; i < nc; i += NT) cand[i] = rows[(size_t)b * L + l0 + i];
  __syncthreads();
  const int ntc = (D + TM - 1) / TM;          // tiles per candidate
  const int ntiles = nc * ntc;
  const char* dbase = static_cast<const char*>(docs);
  const uint32_t ring0 = wg::smem_u32(ring), b0 = wg::smem_u32(bsm);

  // copies of tile t (piece t % ntc of candidate t / ntc) into its slot;
  // rows past D are zero-filled
  auto copy_tile = [&](int t) {
    const int c = t / ntc;
    wg::load_tile<INT8, DIM, NT>(ring0 + (t % STAGES) * slot_bytes,
                                 dbase + (size_t)cand[c] * D * ROW, D,
                                 t - c * ntc);
  };
  // this thread's two rows of tile t: mask bytes (0 past D) and int8
  // scales, read a tile ahead of their use
  auto fetch = [&](int t, uint8_t (&m)[2], float (&sc)[2]) {
    const int c = t / ntc;
    const int64_t n = cand[c];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (t - c * ntc) * TM + wrow + (lane >> 2) + 8 * i;
      m[i] = 0;
      sc[i] = 1.f;
      if (row < D) {
        m[i] = __ldg(dmask + n * dmask_stride + row);
        if (INT8) sc[i] = __ldg(scales + n * D + row);
      }
    }
  };

  for (int pass = 0; pass * TOK < cnt; ++pass) {
    // the operand: tokens pass*TOK .. pass*TOK + TOK-1 of the query, their
    // q_hi rows then their q_lo rows; slots past cnt are zero
    {
      constexpr int CPR = DIM / 8;
      for (int i = tid; i < BR * CPR; i += NT) {
        const int r = i / CPR, c = i % CPR;
        const int tok = pass * TOK + r % TOK, part = r / TOK;
        const bool in = tok < cnt;
        wg::cp16(b0 + wg::sw_off(r, c, BR),
                 qpack + ((size_t)(in ? t0 + tok : 0) * 2 + part) * DIM +
                     c * 8,
                 in ? 16 : 0);
      }
      wg::cp_commit();
    }
#pragma unroll
    for (int k = 0; k < STAGES - 1; ++k) {
      if (k < ntiles) copy_tile(k);
      wg::cp_commit();
    }
    uint8_t ok_next[2];
    float sc_next[2];
    fetch(0, ok_next, sc_next);
    float run[4];                  // running max of 4 token columns
#pragma unroll
    for (int p = 0; p < 4; ++p) run[p] = wg::NEG;

    for (int t = 0; t < ntiles; ++t) {
      wg::cp_wait<STAGES - 2>();   // tile t (and the operand) landed
      wg::fence_async();
      __syncthreads();             // ... and every thread is past tile t-1
      if (t + STAGES - 1 < ntiles) copy_tile(t + STAGES - 1);  // t-1's slot
      wg::cp_commit();
      const char* a = ring + (t % STAGES) * slot_bytes;
      if (INT8) {
        wg::convert_int8<DIM, NT>(a, conv);
        wg::fence_async();
        __syncthreads();
        a = conv;
      }
      const bool ok[2] = {ok_next[0] != 0, ok_next[1] != 0};
      const float sc[2] = {sc_next[0], sc_next[1]};
      if (t + 1 < ntiles) fetch(t + 1, ok_next, sc_next);

      float acc[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) acc[k] = 0.f;
      const uint32_t a0 = wg::smem_u32(a);
      wg::wgmma_fence();
#pragma unroll
      for (int k = 0; k < KS; ++k)
        rr::wgmma_m64n32k16(acc, wg::desc(a0 + wg::kslice(k, TM)),
                            wg::desc(b0 + wg::kslice(k, BR)));
      wg::wgmma_commit();
      wg::wgmma_wait();
      // acc[(p/2)*4 + i*2 + p%2]: row i, token column (p/2)*8 + (lane%4)*2
      // + p%2 (q_hi); 8 further, the same token's q_lo
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int a_ = (p >> 1) * 4 + i * 2 + (p & 1);
          float x = acc[a_] + acc[a_ + 8];
          if (INT8) x *= sc[i];
          run[p] = fmaxf(run[p], ok[i] ? x : wg::NEG);
        }

      if ((t + 1) % ntc == 0) {     // the candidate's last tile
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
#pragma unroll
          for (int p = 0; p < 4; ++p)
            run[p] = fmaxf(run[p], __shfl_xor_sync(0xffffffffu, run[p], off));
        if (lane < 4) {
#pragma unroll
          for (int p = 0; p < 4; ++p)
            red[warp * TOK + (p >> 1) * 8 + lane * 2 + (p & 1)] = run[p];
        }
        __syncthreads();
        if (warp == 0) {
          // no floor: a fully masked candidate sums cnt NEG maxima
          const int tok = pass * TOK + lane;
          float v = 0.f;
          if (lane < TOK && tok < cnt)
            v = fmaxf(fmaxf(red[lane], red[TOK + lane]),
                      fmaxf(red[2 * TOK + lane], red[3 * TOK + lane]));
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          if (lane == 0) {
            const int c = t / ntc;
            outb[c] = pass ? outb[c] + v : v;
          }
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) run[p] = wg::NEG;
      }
    }
    __syncthreads();               // the next pass restages the operand
  }
}

template <bool INT8, int DIM>
int launch_tc_dim(const int32_t* rows, const __nv_bfloat16* qpack,
                  const int* qstart, const int* qcount, const void* docs,
                  const float* scales, const uint8_t* dm, int64_t dm_stride,
                  float* out, int B, int L, int D, cudaStream_t stream) {
  const size_t smem = rr::smem_bytes(DIM, INT8 ? 1 : 2);
  // about TILES tiles a block: several candidates of one query
  const int ntc = (D + wg::TM - 1) / wg::TM;
  int cb = rr::TILES / ntc;
  cb = cb < 1 ? 1 : (cb > rr::CB_MAX ? rr::CB_MAX : cb);
  const int chunks = (L + cb - 1) / cb;
  if (chunks > 65535 || smem > wg::SMEM_MAX ||
      reinterpret_cast<uintptr_t>(docs) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      rerank_wgmma_kernel<INT8, DIM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(rerank_wgmma_kernel<INT8, DIM>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B, chunks);
  rerank_wgmma_kernel<INT8, DIM><<<grid, rr::NT, smem, stream>>>(
      rows, qpack, qstart, qcount, docs, scales, dm, dm_stride, out, L, D,
      cb);
  return static_cast<int>(cudaGetLastError());
}

template <bool INT8>
int launch_tc(const int32_t* rows, const __nv_bfloat16* qpack,
              const int* qstart, const int* qcount, const void* docs,
              const float* scales, const uint8_t* dm, int64_t dm_stride,
              float* out, int B, int L, int D, int d, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_tc_dim<INT8, 32>(rows, qpack, qstart, qcount, docs,
                                     scales, dm, dm_stride, out, B, L, D,
                                     stream);
    case 64:
      return launch_tc_dim<INT8, 64>(rows, qpack, qstart, qcount, docs,
                                     scales, dm, dm_stride, out, B, L, D,
                                     stream);
    case 128:
      return launch_tc_dim<INT8, 128>(rows, qpack, qstart, qcount, docs,
                                      scales, dm, dm_stride, out, B, L, D,
                                      stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace maxsim

// rows [B,L] int32 in-range slot ids, q [B,Q,d] f32, q_mask [B,Q] f32,
// docs [N,D,d] of docs_type (0 f32, 1 bf16, 2 int8 codes with scales [N,D]
// f32; scales is unused otherwise), doc_mask rows of D bytes (row stride
// doc_mask_stride: D, or 0 for one broadcast row), out [B,L] f32. The
// tensor route reads the query from the packed operand instead
// (`ops.scan_query_operand` of q and q_mask: qpack [*, 2, d] bf16,
// qstart/qcount [B] int32); it is required there and must be null on the
// warp route. Returns the launch's cudaError_t.
extern "C" int maxsim_rerank_launch(const void* rows, const void* q,
                                    const void* q_mask, const void* docs,
                                    int docs_type, const void* scales,
                                    const void* doc_mask,
                                    long long doc_mask_stride, void* out,
                                    int B, int L, int Q, int D, int d,
                                    const void* qpack, const void* qstart,
                                    const void* qcount, void* stream) {
  using namespace maxsim;
  const int32_t* r = static_cast<const int32_t*>(rows);
  const float* qf = static_cast<const float*>(q);
  const float* qmf = static_cast<const float*>(q_mask);
  const float* sc = static_cast<const float*>(scales);
  const uint8_t* dm = static_cast<const uint8_t*>(doc_mask);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t st = (int64_t)doc_mask_stride;
  if (wg::tensor_route(docs_type, D, d)) {
    if (!qpack || !qstart || !qcount)
      return static_cast<int>(cudaErrorInvalidValue);  // prepared for warp
    const auto* qp = static_cast<const __nv_bfloat16*>(qpack);
    const int* qs = static_cast<const int*>(qstart);
    const int* qc = static_cast<const int*>(qcount);
    return docs_type == DOC_INT8
               ? launch_tc<true>(r, qp, qs, qc, docs, sc, dm, st, o, B, L, D,
                                 d, s)
               : launch_tc<false>(r, qp, qs, qc, docs, sc, dm, st, o, B, L,
                                  D, d, s);
  }
  if (qpack || qstart || qcount)
    return static_cast<int>(cudaErrorInvalidValue);  // prepared for tensor
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
