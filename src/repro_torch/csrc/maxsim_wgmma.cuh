// Device code of the tensor-core MaxSim scan (`maxsim_scan.cu`, tensor
// route): bf16 wgmma on Hopper with f32 accumulation.
//
// Operands. The documents are the M side: the corpus is read as one
// flattened row space [N*D, d], 64 rows per M tile, so a tile may hold
// rows of several documents (mean_pooling, D = 34) or part of one
// (initial, D = 1024). The query is the N side: the VALID tokens of the
// batch, packed on the card by `ops.scan_query_operand` into a bf16 array
// of (q_hi, q_lo = bf16(q - q_hi)) rows in query order, with each query's
// first row and token count. A block takes whole queries
// greedily into groups of at most TP tokens (the count one block holds)
// and stages each group's tokens in shared memory in chunks of 64: 128
// operand rows, the 64 q_hi rows then the 64 q_lo rows. One m64n128k16
// product per 16-element slice of d gives, in one accumulator, docs.q_hi
// in columns 0-63 and docs.q_lo in columns 64-127; the epilogue adds the
// two, which carries the f32 query to within 2^-16 relative. bf16
// documents are exact in bf16; int8 codes too (|c| <= 127), and their
// per-row scale multiplies the sum after the product. The grouping is
// the block's own, so the host never waits for the card to lay it out.
//
// Shared memory: both operands K-major in the 128-byte swizzled layout
// that wgmma reads without bank conflicts. An operand of R rows is cut
// along d into atoms of 64 elements (128 bytes); atom a holds all R rows,
// 8-row groups of 1024 bytes one after another, and the 16-byte chunk c
// of row r sits at chunk position c ^ (r % 8) of its 128-byte row. In the
// descriptor the stride byte offset (next 8 rows) is 1024; the k-th
// 16-element slice starts at atom k / 4, byte (k % 4) * 32 of each row.
//
// Two consumer warpgroups share each M tile and split the chunks (chunk c
// to warpgroup c % 2), so one warpgroup's epilogue runs on the CUDA cores
// while the other's products run on the tensor cores.
//
// Epilogue. Per chunk each thread holds 2 rows x 16 token columns; a
// masked row scores NEG. While the tiles belong to one document (initial,
// D = 1024: always), each thread only folds them into a running max in
// registers, per chunk. When that document ends, or a tile holds rows of
// several documents (mean_pooling), a butterfly over the lanes takes the
// column max per document and lanes 0-3 fold it into a per-(document,
// token) running max in shared memory (atomicMax on order-preserving int
// keys), which also joins the 4 warps of a warpgroup. When a tile ends a
// document, the group's queries each sum their tokens' maxima, floored at
// NEG/2, and write scores[b, n].
//
// Callers: the scan (`maxsim_scan.cu`) and the double-buffered scan
// (`maxsim_scan_db.cu`) both launch `scan_wgmma_kernel` through
// `launch_scan`; the gather-rerank (`maxsim_rerank.cu`) builds its own
// kernel from the swizzle, descriptors, tile loads and int8 conversion
// here. All three take the tensor route by `tensor_route`, the rule's one
// statement.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "maxsim_common.cuh"

namespace wg {

constexpr float NEG = -1e30f;
constexpr int TM = 64;            // document rows per M tile
constexpr int CH = 64;            // query tokens per N chunk (hi + lo rows)
constexpr int STAGES = 3;         // cp.async ring of M tiles
constexpr int NSLOT = 8;          // open documents a tile can touch (D >= 16)
constexpr int WGS = 2;            // consumer warpgroups, chunks split
constexpr int THREADS = 128 * WGS;
constexpr int NCW = 3;            // chunks per warpgroup at most
constexpr int MIN_D = 16;         // the tensor route's smallest document
constexpr size_t SMEM_MAX = 232448;  // opt-in shared memory per block

// The route of a scan or rerank of docs_type (maxsim::DocType) with D
// vectors of dim d per document: true = tensor cores (bf16 documents or
// int8 codes, D >= MIN_D, d of 32, 64 or 128), false = the f32 warp
// kernels. A 64-row tile of fewer vectors would waste most of a product.
inline bool tensor_route(int docs_type, int D, int d) {
  return docs_type != maxsim::DOC_F32 && D >= MIN_D &&
         (d == 32 || d == 64 || d == 128);
}

// d rounded up to whole 64-element swizzle atoms.
__host__ __device__ inline int padded_d(int d) { return (d + 63) / 64 * 64; }

// Shared memory of the tensor route for groups of at most TP tokens (a
// multiple of CH), vector dim d and document element size esize (2 bf16,
// 1 int8).
__host__ __device__ inline size_t smem_bytes(int TP, int d, int esize) {
  const int dp = padded_d(d);
  size_t b = (size_t)TP * 2 * dp * 2;                // q_hi / q_lo operand
  b += esize == 2 ? (size_t)STAGES * TM * dp * 2     // bf16 M tile ring
                  : (size_t)STAGES * TM * d          // raw int8 ring
                        + (size_t)TM * dp * 2;       // int8 -> bf16 tile
  b += (size_t)NSLOT * TP * 4;                       // running max keys
  return b + 1024;                                   // atom alignment
}

// Largest tokens per group (a multiple of CH) whose operand fits and
// whose chunks the warpgroups' registers hold.
inline int token_cap(int d, int esize) {
  int tp = 0;
  while (tp + CH <= WGS * NCW * CH && smem_bytes(tp + CH, d, esize) <= SMEM_MAX)
    tp += CH;
  return tp;
}

__device__ __forceinline__ int key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float unkey(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// Byte offset of 16-byte chunk c of row r in an R-row swizzled operand.
__device__ __forceinline__ uint32_t sw_off(int r, int c, int R) {
  return (uint32_t)((c >> 3) * (R * 128) + (r >> 3) * 1024 + (r & 7) * 128 +
                    (((c & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte cp.async; bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Make this thread's generic-proxy shared-memory writes visible to wgmma.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma matrix descriptor of a K-major 128-byte swizzled operand: start
// address, leading byte offset unused (1), stride byte offset 1024 (next
// 8 rows), layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  uint64_t v = (uint64_t)((addr & 0x3ffff) >> 4);
  v |= (uint64_t)1 << 16;
  v |= (uint64_t)(1024 >> 4) << 32;
  v |= (uint64_t)1 << 62;
  return v;
}

// Byte offset of the k-th 16-element slice in an R-row swizzled operand.
__device__ __forceinline__ uint32_t kslice(int k, int R) {
  return (uint32_t)((k >> 2) * (R * 128) + (k & 3) * 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until this warpgroup's committed products are done.
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// acc[64] (+)= A[64 x 16] . B[128 x 16]^T, both bf16 K-major in shared
// memory; scale_d = 0 overwrites the accumulator.
__device__ __forceinline__ void wgmma_m64n128k16(float (&c)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]), "+f"(c[4]),
        "+f"(c[5]), "+f"(c[6]), "+f"(c[7]), "+f"(c[8]), "+f"(c[9]),
        "+f"(c[10]), "+f"(c[11]), "+f"(c[12]), "+f"(c[13]), "+f"(c[14]),
        "+f"(c[15]), "+f"(c[16]), "+f"(c[17]), "+f"(c[18]), "+f"(c[19]),
        "+f"(c[20]), "+f"(c[21]), "+f"(c[22]), "+f"(c[23]), "+f"(c[24]),
        "+f"(c[25]), "+f"(c[26]), "+f"(c[27]), "+f"(c[28]), "+f"(c[29]),
        "+f"(c[30]), "+f"(c[31]), "+f"(c[32]), "+f"(c[33]), "+f"(c[34]),
        "+f"(c[35]), "+f"(c[36]), "+f"(c[37]), "+f"(c[38]), "+f"(c[39]),
        "+f"(c[40]), "+f"(c[41]), "+f"(c[42]), "+f"(c[43]), "+f"(c[44]),
        "+f"(c[45]), "+f"(c[46]), "+f"(c[47]), "+f"(c[48]), "+f"(c[49]),
        "+f"(c[50]), "+f"(c[51]), "+f"(c[52]), "+f"(c[53]), "+f"(c[54]),
        "+f"(c[55]), "+f"(c[56]), "+f"(c[57]), "+f"(c[58]), "+f"(c[59]),
        "+f"(c[60]), "+f"(c[61]), "+f"(c[62]), "+f"(c[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Issue the cp.async copies of M tile `t` (local rows t*TM ...) of a
// block's rows (`base`, `nrows` of them) into ring slot `dst`: bf16 rows
// straight into the swizzled layout; int8 rows as raw 16-code chunks,
// chunk c of row r at c * TM * 16 + r * 16 (so that the conversion reads
// consecutive rows from consecutive threads). Rows at or beyond nrows are
// zero-filled.
// NT threads of the block share the copies.
template <bool INT8, int DIM, int NT = THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, const char* base,
                                          int nrows, int t) {
  constexpr int ROW = DIM * (INT8 ? 1 : 2);       // bytes per row
  constexpr int CPR = ROW / 16;                   // 16-byte chunks per row
  for (int i = threadIdx.x; i < TM * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR;
    const int row = t * TM + r;
    const bool in = row < nrows;
    const uint32_t off = INT8 ? (uint32_t)(c * TM * 16 + r * 16)
                              : sw_off(r, c, TM);
    cp16(dst + off, base + (size_t)(in ? row : 0) * ROW + c * 16,
         in ? 16 : 0);
  }
}

// int8 codes of one raw tile -> bf16 in the swizzled layout, by NT
// threads.
template <int DIM, int NT = THREADS>
__device__ __forceinline__ void convert_int8(const char* raw, char* out) {
  for (int i = threadIdx.x; i < TM * DIM / 16; i += NT) {
    const int r = i % TM, c = i / TM;
    const int4 v = *reinterpret_cast<const int4*>(raw + c * TM * 16 + r * 16);
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
    __align__(16) __nv_bfloat16 h[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) h[k] = __float2bfloat16_rn((float)b[k]);
    *reinterpret_cast<int4*>(out + sw_off(r, 2 * c, TM)) =
        *reinterpret_cast<const int4*>(h);
    *reinterpret_cast<int4*>(out + sw_off(r, 2 * c + 1, TM)) =
        *reinterpret_cast<const int4*>(h + 8);
  }
}

// Column max over the warp's 16 rows (lanes sharing lane % 4) of m[p],
// p = token column (p / 2) * 8 + (lane % 4) * 2 + p % 2 of a chunk, folded
// by lanes 0-3 into the running-max keys `slot` of that chunk.
__device__ __forceinline__ void fold_warp(float (&m)[16], int* slot,
                                          int lane) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int p = 0; p < 16; ++p)
      m[p] = fmaxf(m[p], __shfl_xor_sync(0xffffffffu, m[p], off));
  if (lane < 4) {
#pragma unroll
    for (int p = 0; p < 16; ++p)
      atomicMax(slot + (p >> 1) * 8 + lane * 2 + (p & 1), key(m[p]));
  }
}

// Fold a warpgroup's register running maxima (its chunks wgi, wgi + WGS,
// ...) of one document into that document's shared-memory keys `slot`.
__device__ __forceinline__ void flush(float (&run)[NCW][16], int* slot,
                                      int wgi, int nch, int lane) {
#pragma unroll
  for (int kk = 0; kk < NCW; ++kk) {
    const int c = wgi + WGS * kk;
    if (c < nch) fold_warp(run[kk], slot + c * CH, lane);
  }
}

// Scores of every query against one contiguous range of whole documents
// (blockIdx.x). qpack [*, 2, DIM] bf16: the valid tokens' (q_hi, q_lo) in
// query order; qstart/qcount [B]: query b's first token and token count.
// The block walks the queries in groups of at most TP tokens (a multiple
// of CH), staging each group in shared memory and streaming its document
// range once per group. The product's DIM/16 slices are unrolled, so the
// accumulator stays in place between the asynchronous products. Rows and
// documents are counted from the block's first (32-bit, so the per-tile
// bookkeeping is cheap).
template <bool INT8, int DIM>
__global__ void __launch_bounds__(THREADS, 1)
scan_wgmma_kernel(const __nv_bfloat16* __restrict__ qpack,
                  const int* __restrict__ qstart,
                  const int* __restrict__ qcount, int B, int TP,
                  const void* __restrict__ docs,
                  const float* __restrict__ scales,
                  const uint8_t* __restrict__ dmask, int64_t dmask_stride,
                  float* __restrict__ out, int N, int D) {
  constexpr int KS = DIM / 16;
  constexpr int DP = (DIM + 63) / 64 * 64;
  extern __shared__ __align__(1024) char smem_raw[];
  // the swizzle pattern follows address bits 4-9: atoms start 1024-aligned
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  char* smem = smem_raw + pad;
  char* bsm = smem;                                        // query operand
  char* ring = bsm + (size_t)TP * 2 * DP * 2;              // M tile ring
  constexpr int slot_bytes = INT8 ? TM * DIM : TM * DP * 2;
  char* conv = ring + STAGES * slot_bytes;                 // int8 -> bf16
  int* best = reinterpret_cast<int*>(conv + (INT8 ? TM * DP * 2 : 0));

  const int R = gridDim.x;
  const int64_t n0 = (int64_t)N * blockIdx.x / R;
  const int nd = (int)((int64_t)N * (blockIdx.x + 1) / R - n0);
  if (nd <= 0) return;
  const int nrows = nd * D;                  // this block's rows
  const char* base = static_cast<const char*>(docs) +
                     (size_t)n0 * D * DIM * (INT8 ? 1 : 2);
  const uint8_t* dmb = dmask + n0 * dmask_stride;
  const float* scb = INT8 ? scales + n0 * D : nullptr;
  float* outb = out + n0;
  const int ntiles = (nrows + TM - 1) / TM;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wgi = tid >> 7;                 // this thread's warpgroup
  const int wrow = ((tid >> 5) & 3) * 16;   // its warp's rows in the tile
  const uint32_t ring0 = smem_u32(ring);

  // this thread's two rows of tile t: their mask bytes and int8 scales,
  // read one tile ahead and first used a tile later, so that the loads'
  // latency hides behind a tile (nothing here may use the loaded values)
  auto fetch = [&](int t, uint8_t (&m)[2], float (&sc)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = t * TM + wrow + (lane >> 2) + 8 * i;
      m[i] = 0;
      sc[i] = 1.f;
      if (row < nrows) {
        const int doc = row / D;
        m[i] = __ldg(dmb + doc * dmask_stride + (row - doc * D));
        if (INT8) sc[i] = __ldg(scb + row);
      }
    }
  };

  for (int q_lo = 0, q_hi; q_lo < B; q_lo = q_hi) {
    // the next group: whole queries while their tokens fit TP
    const int t0 = qstart[q_lo];
    int ntok = 0;
    for (q_hi = q_lo; q_hi < B && ntok + qcount[q_hi] <= TP; ++q_hi)
      ntok += qcount[q_hi];
    if (q_hi == q_lo) __trap();          // a query above TP: refused on host
    const int nch = ntok > 0 ? (ntok + CH - 1) / CH : 1;

    // the group's query operand: chunk c holds tokens c*CH .. c*CH+CH-1,
    // their q_hi rows then their q_lo rows; slots past ntok are zero
    {
      constexpr int CPR = DIM / 8;
      const int rows = nch * 2 * CH;
      const uint32_t b0 = smem_u32(bsm);
      for (int i = tid; i < rows * CPR; i += THREADS) {
        const int r = i / CPR, c = i % CPR;
        const int tok = (r / (2 * CH)) * CH + r % CH, part = (r / CH) & 1;
        const bool in = tok < ntok;
        cp16(b0 + sw_off(r, c, 2 * TP),
             qpack + ((size_t)(in ? t0 + tok : 0) * 2 + part) * DIM + c * 8,
             in ? 16 : 0);
      }
      cp_commit();
    }
    for (int i = tid; i < NSLOT * TP; i += THREADS) best[i] = key(NEG);
    load_tile<INT8, DIM>(ring0, base, nrows, 0);
    cp_commit();
    if (ntiles > 1) load_tile<INT8, DIM>(ring0 + slot_bytes, base, nrows, 1);
    cp_commit();
    uint8_t ok_next[2];
    float sc_next[2];
    fetch(0, ok_next, sc_next);

    int fin = 0;                           // first document not yet written
    float run[NCW][16];                    // running max of document run_doc
    int run_doc = -1;

    for (int t = 0; t < ntiles; ++t) {
      if (t + 2 < ntiles)
        load_tile<INT8, DIM>(ring0 + ((t + 2) % STAGES) * slot_bytes, base,
                             nrows, t + 2);
      cp_commit();
      cp_wait<2>();                        // tile t (and the operand) landed
      fence_async();
      __syncthreads();
      const char* a = ring + (t % STAGES) * slot_bytes;
      if (INT8) {
        convert_int8<DIM>(a, conv);
        fence_async();
        __syncthreads();
        a = conv;
      }
      const uint32_t a0 = smem_u32(a), b0 = smem_u32(bsm);

      // the tile's rows and documents; this thread's two rows
      const int tr0 = t * TM;
      const int tend = tr0 + TM < nrows ? tr0 + TM : nrows;
      const int tdoc = tr0 / D;
      const bool single = (tend - 1) / D == tdoc;     // block-uniform
      int doc[2];
      const bool ok[2] = {ok_next[0] != 0, ok_next[1] != 0};
      const float sc[2] = {sc_next[0], sc_next[1]};
      if (t + 1 < ntiles) fetch(t + 1, ok_next, sc_next);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = tr0 + wrow + (lane >> 2) + 8 * i;
        doc[i] = row < nrows ? (single ? tdoc : row / D) : -1;
      }
      if (run_doc >= 0 && (!single || run_doc != tdoc)) {
        flush(run, best + (run_doc % NSLOT) * TP, wgi, nch, lane);
        run_doc = -1;
      }
      if (single && run_doc < 0) {
        run_doc = tdoc;
#pragma unroll
        for (int kk = 0; kk < NCW; ++kk)
#pragma unroll
          for (int p = 0; p < 16; ++p) run[kk][p] = NEG;
      }
      // the documents of this warp's 16 rows: dlo .. dhi
      const int s0 = tr0 + wrow;
      const int s1 = s0 + 15 < nrows ? s0 + 15 : nrows - 1;
      const int dlo = s0 / D, dhi = s0 <= s1 ? s1 / D : dlo - 1;

      // this warpgroup's chunks c = wgi, wgi + WGS, ...
#pragma unroll
      for (int kk = 0; kk < NCW; ++kk) {
        const int c = wgi + WGS * kk;
        if (c >= nch) break;                          // warpgroup-uniform
        float acc[64];
#pragma unroll
        for (int k = 0; k < 64; ++k) acc[k] = 0.f;
        const uint32_t bc = b0 + c * (2 * CH / 8) * 1024;  // chunk c's rows
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < KS; ++k)
          wgmma_m64n128k16(acc, desc(a0 + kslice(k, TM)),
                           desc(bc + kslice(k, 2 * TP)), 1);
        wgmma_commit();
        wgmma_wait();
        // v[i][p]: row i, token column (p / 2) * 8 + (lane % 4) * 2 + p % 2
        float v[2][16];
#pragma unroll
        for (int p = 0; p < 16; ++p)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int a_ = (p >> 1) * 4 + i * 2 + (p & 1);
            float x = acc[a_] + acc[a_ + 32];              // q_hi + q_lo
            if (INT8) x *= sc[i];
            v[i][p] = ok[i] ? x : NEG;
          }
        if (single) {
#pragma unroll
          for (int p = 0; p < 16; ++p)
            run[kk][p] = fmaxf(run[kk][p], fmaxf(v[0][p], v[1][p]));
        } else {
          for (int dd = dlo; dd <= dhi; ++dd) {       // warp-uniform
            float m[16];
#pragma unroll
            for (int p = 0; p < 16; ++p)
              m[p] = fmaxf(doc[0] == dd ? v[0][p] : NEG,
                           doc[1] == dd ? v[1][p] : NEG);
            fold_warp(m, best + (dd % NSLOT) * TP + c * CH, lane);
          }
        }
      }
      // a document that ends in this tile leaves the registers now
      if (run_doc >= 0 && (run_doc + 1) * D <= tend) {
        flush(run, best + (run_doc % NSLOT) * TP, wgi, nch, lane);
        run_doc = -1;
      }
      __syncthreads();                     // every warp folded this tile

      // documents that end in this tile: write their scores, free the slots
      const int fend = tend / D;           // documents [fin, fend) are complete
      if (fend > fin) {
        for (int dd = fin; dd < fend; ++dd) {
          const int* slot = best + (dd % NSLOT) * TP;
          for (int b = q_lo + tid; b < q_hi; b += THREADS) {
            const int st = qstart[b] - t0, cnt = qcount[b];
            float s = 0.f;
            for (int k = 0; k < cnt; ++k)
              s += fmaxf(unkey(slot[st + k]), 0.5f * NEG);
            outb[(size_t)b * N + dd] = s;
          }
        }
        __syncthreads();
        for (int dd = fin; dd < fend; ++dd) {
          int* slot = best + (dd % NSLOT) * TP;
          for (int i = tid; i < TP; i += THREADS) slot[i] = key(NEG);
        }
        fin = fend;
      }
    }
    __syncthreads();                     // the next group reuses the tiles
  }
}

// Launch `scan_wgmma_kernel` over docs [N, D, DIM] (bf16, or int8 codes
// with scales [N, D]): one block per SM, each over a range of whole
// documents; qpack/qstart/qcount as the kernel takes them, TP tokens per
// group (a multiple of CH within `token_cap`). Returns the cudaError_t.
template <bool INT8, int DIM>
int launch_scan_dim(const __nv_bfloat16* qpack, const int* qstart,
                    const int* qcount, int B, int TP, const void* docs,
                    const float* scales, const uint8_t* dm,
                    int64_t dm_stride, float* out, int N, int D,
                    cudaStream_t stream) {
  const size_t smem = smem_bytes(TP, DIM, INT8 ? 1 : 2);
  if (TP <= 0 || TP % CH || TP > token_cap(DIM, INT8 ? 1 : 2) ||
      smem > SMEM_MAX || reinterpret_cast<uintptr_t>(docs) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      scan_wgmma_kernel<INT8, DIM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // one block per SM, each over a range of whole documents
  const int ranges = N < sms ? N : sms;
  // a block counts its rows in 32 bits
  if ((int64_t)(N / ranges + 1) * D > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  scan_wgmma_kernel<INT8, DIM><<<ranges, THREADS, smem, stream>>>(
      qpack, qstart, qcount, B, TP, docs, scales, dm, dm_stride, out, N, D);
  return static_cast<int>(cudaGetLastError());
}

// `launch_scan_dim` for a run-time d (32, 64 or 128).
template <bool INT8>
int launch_scan_d(const __nv_bfloat16* qpack, const int* qstart,
                  const int* qcount, int B, int TP, const void* docs,
                  const float* scales, const uint8_t* dm, int64_t dm_stride,
                  float* out, int N, int D, int d, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_scan_dim<INT8, 32>(qpack, qstart, qcount, B, TP, docs,
                                       scales, dm, dm_stride, out, N, D,
                                       stream);
    case 64:
      return launch_scan_dim<INT8, 64>(qpack, qstart, qcount, B, TP, docs,
                                       scales, dm, dm_stride, out, N, D,
                                       stream);
    case 128:
      return launch_scan_dim<INT8, 128>(qpack, qstart, qcount, B, TP, docs,
                                        scales, dm, dm_stride, out, N, D,
                                        stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// A launcher's tensor route for docs of docs_type (maxsim::DocType) as
// the C entry points receive them; a call prepared for the warp route
// (no packed query, TP 0) is refused.
inline int launch_scan(const void* qpack, const void* qstart,
                       const void* qcount, int B, int TP, const void* docs,
                       int docs_type, const float* scales, const uint8_t* dm,
                       int64_t dm_stride, float* out, int N, int D, int d,
                       cudaStream_t stream) {
  if (!qpack || !qstart || !qcount || TP <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qp = static_cast<const __nv_bfloat16*>(qpack);
  const int* qs = static_cast<const int*>(qstart);
  const int* qc = static_cast<const int*>(qcount);
  return docs_type == maxsim::DOC_INT8
             ? launch_scan_d<true>(qp, qs, qc, B, TP, docs, scales, dm,
                                   dm_stride, out, N, D, d, stream)
             : launch_scan_d<false>(qp, qs, qc, B, TP, docs, scales, dm,
                                    dm_stride, out, N, D, d, stream);
}

}  // namespace wg
