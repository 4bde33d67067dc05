// Double-buffered streaming MaxSim scan: scores[b, n] for every query b
// against every document n of a corpus, in one launch.
//
// Replaces the TPU kernel `maxsim_pallas_db` (src/repro/kernels/maxsim/
// maxsim.py:181, body `_maxsim_db_kernel`). There one launch walks the
// corpus in chunks with the whole [B, Q, d] query block resident in VMEM,
// and the DMA of chunk i+1 into the idle half of a 2-slot buffer is in
// flight while the MXU scores chunk i (`make_async_copy` + DMA
// semaphores).
//
// On Hopper that design is the tensor-route scan's kernel,
// `wg::scan_wgmma_kernel` of maxsim_wgmma.cuh, and this file launches it
// (`wg::launch_scan`) for the shapes of its route (`wg::tensor_route`:
// bf16 documents or int8 codes, D >= 16, d of 32, 64 or 128):
// - The resident query block becomes the packed VALID query tokens of a
//   group of whole queries in shared memory, split into bf16 hi + lo rows
//   (`ops.scan_query_operand`); one group holds the main path's 32
//   queries, so each block streams its documents once.
// - The 2-slot DMA buffer becomes a 3-slot `cp.async` ring of 64-row
//   document tiles: the copies of tiles i+1 and i+2 are in flight while
//   the tensor cores score tile i (`cp.async.wait_group` plus a block
//   barrier play the DMA semaphore wait).
// - The TPU's sequential chunk axis becomes one block per SM over a range
//   of whole documents, since blocks run in parallel in no order; the
//   per-token running max stays in registers while tiles belong to one
//   document. Which chunk the caller names changes no score.
// What bounds it: the split product, 4*T*N*D*d operations for T valid
// tokens at 989 TFLOP/s, as for the scan.
//
// The warp route (f32 documents, D < 16, another d) is the f32 kernel
// below: the batch in query groups of up to 8 queries (one warp each)
// resident in shared memory, each block streaming a document range
// through two shared-memory tiles of DB_TILE vectors; tile i+1 is copied
// with 16-byte (f32, bf16) or 8-byte (int8) `cp.async` while the warps
// score tile i. A document longer than a tile spans several, and each
// warp carries the per-token running max across them in shared memory.
// Staged rows are padded by 16 (8 for int8) bytes so that the 32 lanes,
// each reading its own row, hit distinct banks. It is bound by the f32
// multiply-adds at 67 TFLOP/s.
//
// Both routes mask ragged N, D and Q themselves and read masks with a row
// stride (0 for a broadcast [1, D] mask). The output contract is the
// scan's: each valid query token's max is floored at NEG/2, masked tokens
// add 0; the wrapper applies doc_valid.
#include "maxsim_common.cuh"
#include "maxsim_wgmma.cuh"

namespace maxsim {

constexpr int DB_TILE = 64;     // document vectors per staged tile
constexpr int DB_MAX_QB = 8;    // queries (warps) per block

template <typename T>
struct DbStage {
  static constexpr int CHUNK = kInt8<T> ? 8 : 16;          // bytes per copy
  static constexpr int PAD = CHUNK / (int)sizeof(T);        // row pad, elems
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory of one block: the group's queries, their masks, the
// per-token running max, then the two tiles.
template <typename T>
size_t db_smem_bytes(int qb, int Qp, int d) {
  const size_t head = ((size_t)qb * Qp * d + 2 * (size_t)qb * Qp) * 4;
  return head + 2 * (size_t)DB_TILE * (d + DbStage<T>::PAD) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(DB_MAX_QB * 32)
maxsim_scan_db_kernel(const float* __restrict__ q,
                      const float* __restrict__ qmask,
                      const T* __restrict__ docs,
                      const float* __restrict__ scales,
                      const uint8_t* __restrict__ dmask, int64_t dmask_stride,
                      float* __restrict__ out, int B, int Q, int Qp, int N,
                      int D, int d, int qb, int docs_per_block) {
  using S = DbStage<T>;
  extern __shared__ float4 smem4[];
  const int stride = d + S::PAD;                // staged row, elements
  float* qs = reinterpret_cast<float*>(smem4);  // [qb][Qp][d]
  float* qm = qs + (size_t)qb * Qp * d;         // [qb][Qp]
  float* rm = qm + qb * Qp;                     // [qb][Qp] running max
  T* tiles = reinterpret_cast<T*>(rm + qb * Qp);  // [2][DB_TILE][stride]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * qb;
  const int b = b0 + warp;

  // the group's resident query block (zero rows past B and Q)
  const int qsz = Qp * d;
  for (int i = threadIdx.x; i < qb * qsz; i += blockDim.x) {
    const int w = i / qsz, r = i - w * qsz, t = r / d;
    qs[i] = (b0 + w < B && t < Q)
                ? q[((size_t)(b0 + w) * Q + t) * d + (r - t * d)]
                : 0.f;
  }
  for (int i = threadIdx.x; i < qb * Qp; i += blockDim.x) {
    const int w = i / Qp, t = i - w * Qp;
    qm[i] = (b0 + w < B && t < Q) ? qmask[(size_t)(b0 + w) * Q + t] : 0.f;
  }

  const int n0 = blockIdx.y * docs_per_block;
  const int n1 = min(N, n0 + docs_per_block);
  const int pieces = (D + DB_TILE - 1) / DB_TILE;   // tiles per document
  const int64_t n_tiles = (int64_t)(n1 - n0) * pieces;
  const int row_chunks = d * (int)sizeof(T) / S::CHUNK;

  // start the copy of tile i into slot `slot` (every thread commits a
  // group, possibly empty, so the wait counts agree across threads)
  auto start_copy = [&](int64_t i, int slot) {
    const int64_t n = n0 + i / pieces;
    const int j0 = (int)(i % pieces) * DB_TILE;
    const int nv = min(DB_TILE, D - j0);
    const char* src = reinterpret_cast<const char*>(
        docs + ((size_t)n * D + j0) * d);
    char* dst = reinterpret_cast<char*>(
        tiles + (size_t)slot * DB_TILE * stride);
    for (int c = threadIdx.x; c < nv * row_chunks; c += blockDim.x) {
      const int r = c / row_chunks, cc = c - r * row_chunks;
      cp_async<S::CHUNK>(dst + ((size_t)r * stride * sizeof(T)) + cc * S::CHUNK,
                         src + ((size_t)r * d * sizeof(T)) + cc * S::CHUNK);
    }
    cp_async_commit();
  };

  if (n_tiles > 0) start_copy(0, 0);
  for (int64_t i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      start_copy(i + 1, (int)((i + 1) & 1));   // in flight while tile i is scored
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                      // tile i (and the queries) visible
    const int64_t n = n0 + i / pieces;
    const int p = (int)(i % pieces);
    const int j0 = p * DB_TILE;
    const int nv = min(DB_TILE, D - j0);
    if (b < B) {                          // warp-uniform
      const T* tile = tiles + (size_t)(i & 1) * DB_TILE * stride;
      const float* wq = qs + (size_t)warp * qsz;
      float* wrm = rm + warp * Qp;
      for (int q0 = 0; q0 < Qp; q0 += QT) {
        float best[QT];
        warp_rows_max<T, true>(
            wq + (size_t)q0 * d, tile, stride, dmask + n * dmask_stride + j0,
            kInt8<T> ? scales + (size_t)n * D + j0 : nullptr, nv, d, best);
        if (lane == 0) {
#pragma unroll
          for (int t = 0; t < QT; ++t)
            wrm[q0 + t] = p == 0 ? best[t] : fmaxf(wrm[q0 + t], best[t]);
        }
      }
      if (p == pieces - 1 && lane == 0) {
        const float* wqm = qm + warp * Qp;
        float total = 0.f;
        for (int t = 0; t < Qp; ++t)
          if (wqm[t] > 0.f) total += fmaxf(wrm[t], 0.5f * NEG);
        out[(size_t)b * N + n] = total;
      }
    }
    __syncthreads();                      // slot i&1 is free for tile i+2
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

template <typename T>
int launch(const float* q, const float* qm, const void* docs,
           const float* scales, const uint8_t* dm, int64_t dm_stride,
           float* out, int B, int Q, int N, int D, int d,
           cudaStream_t stream) {
  const int Qp = padded_q(Q);
  int qb = B < DB_MAX_QB ? B : DB_MAX_QB;
  while (qb > 1 && db_smem_bytes<T>(qb, Qp, d) > wg::SMEM_MAX) --qb;
  const size_t smem = db_smem_bytes<T>(qb, Qp, d);
  if (smem > wg::SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (B + qb - 1) / qb;
  // about four blocks per SM over the whole grid
  int ranges = (4 * sm_count() + groups - 1) / groups;
  if (ranges > N) ranges = N;
  if (ranges > 65535) ranges = 65535;
  const int per = (N + ranges - 1) / ranges;
  ranges = (N + per - 1) / per;
  cudaError_t e = cudaFuncSetAttribute(
      maxsim_scan_db_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  maxsim_scan_db_kernel<T><<<dim3(groups, ranges), qb * 32, smem, stream>>>(
      q, qm, static_cast<const T*>(docs), scales, dm, dm_stride, out, B, Q,
      Qp, N, D, d, qb, per);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace maxsim

// q [B,Q,d] f32, q_mask [B,Q] f32, docs [N,D,d] of docs_type (0 f32,
// 1 bf16, 2 int8 codes with scales [N,D] f32; scales is unused otherwise),
// doc_mask rows of D bytes (row stride doc_mask_stride: D, or 0 for one
// broadcast row), out [B,N] f32. The tensor route reads the query from
// the packed operand instead, as `maxsim_scan_launch` does: qpack [*, 2,
// d] bf16, qstart/qcount [B] int32 and TP, the tokens a group may hold
// (`maxsim_scan_token_cap`); they are required there and must be null
// (TP 0) on the warp route. Returns the launch's cudaError_t
// (cudaErrorInvalidValue when even one query does not fit the block's
// shared memory).
extern "C" int maxsim_scan_db_launch(const void* q, const void* q_mask,
                                     const void* docs, int docs_type,
                                     const void* scales, const void* doc_mask,
                                     long long doc_mask_stride, void* out,
                                     int B, int Q, int N, int D, int d,
                                     const void* qpack, const void* qstart,
                                     const void* qcount, int TP,
                                     void* stream) {
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
