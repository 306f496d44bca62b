// Tensor-core and copy helpers of the flash-attention kernels for Hopper
// (sm_90a): 3xTF32 mma.sync products, cp.async tile copies into swizzled
// shared memory, and the fragment loads that read them; and, for the
// bf16 kernels, bf16 mma.sync and ldmatrix, warpgroup products (wgmma)
// with their shared-memory descriptors, TMA tile copies with their
// barriers, and the tensor maps those copies read (built on the host).
// Included by flash_attention_fwd.cu and flash_attention_bwd.cu.  The
// split and the mma wrapper are copies of lstm_fwd.cu's: each .cu builds
// into its own library, so nothing is shared between them.
//
// Fragments of mma.sync.m16n8k8.tf32 (g = lane / 4, t = lane % 4):
//   A (16 x 8):  a0 (g, k t), a1 (g + 8, k t), a2 (g, k t+4), a3 (g+8, k t+4)
//   B (8 x 8):   b0 (k t, n g), b1 (k t+4, n g)
//   C (16 x 8):  c0 (g, 2t), c1 (g, 2t+1), c2 (g + 8, 2t), c3 (g + 8, 2t+1)
// The order of the 8 terms of a k-step does not change the product, so
// every product here maps the mma's k index t to column 2t and t + 4 to
// column 2t + 1 of its 8-column step, in A and B alike.  Then a C
// fragment (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1) is already the A
// fragment of the next product over those columns (a = c0, c2, c1, c3):
// the scores and their gradients go from one product into the next in
// registers, and A and row-wise B fragments are pairs of neighbouring
// elements, one 8-byte (fp32) or 4-byte (bf16) shared load each.
//
// Shared tiles are [64 rows][D columns] of the input type, rows
// unpadded, their 16-byte chunks XOR-swizzled by swz(row), masked to the
// row's chunk count so a chunk never leaves its row.  With 8 or more
// chunks a row (fp32 D >= 32, bf16 D = 64) the swizzle leaves every
// access of the kernels free of bank conflicts:
//   * cp.async: 8 lanes write 8 chunks of one row (any XOR does);
//   * A and row-wise B pairs, (row r0 + g, column c0 + 2t): in fp32 a
//     half-warp's 16 float2 need swz(r) >> 1 distinct over rows 0-3 and
//     over rows 4-7; in bf16 the warp's 32 words need swz a permutation
//     of rows 0-7;
//   * column-wise B, (row k0 + 2t + e, column n0 + g): rows {0, 2, 4, 6}
//     and {1, 3, 5, 7} need swz(r) >> 1 (fp32) or swz(r) (bf16)
//     distinct.
// swz = 0, 2, 4, 6, 3, 1, 7, 5 for rows 0-7 meets all of them.  Narrower
// rows (fp32 D = 8, 16; bf16 D = 8, 16, 32) are a whole 128-byte line or
// less for every 8 rows, so some of those accesses take two to four
// wavefronts: slower, not wrong, on calls that move few bytes.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_attention_common.cuh"

namespace flash {

__device__ __forceinline__ int swz(int row) {
  const int hi = (row >> 2) & 1;
  return (((row & 3) ^ hi) << 1) | hi;
}

// where chunk c of a row of a swizzled [rows][D] tile of T lies in it
template <int D, typename T>
__device__ __forceinline__ int chunk_at(int row, int c) {
  constexpr int CPR = D * (int)sizeof(T) / 16;   // chunks per row
  static_assert(CPR >= 1 && (CPR & (CPR - 1)) == 0,
                "a row is a power-of-two count of 16-byte chunks");
  return c ^ (swz(row) & (CPR - 1));
}

// element offset of (row, col) in a swizzled [rows][D] tile of T
template <int D, typename T>
__device__ __forceinline__ int at(int row, int col) {
  constexpr int E = 16 / sizeof(T);      // elements per 16-byte chunk
  return row * D + chunk_at<D, T>(row, col / E) * E + col % E;
}

// (row, col) and (row, col + 1), col even, as two floats
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float x, float y) {
  // round to nearest even, as torch rounds
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// v ~ hi + lo in TF32 (10 mantissa bits): hi rounds to nearest, ties away
// (as cvt.rna.tf32.f32 does), v - hi is exact, and the tensor core reads
// lo's top 10 mantissa bits (truncation), so |v - hi - lo| < 2^-21 |v|.
// Three full-rate operations: cvt is a slow instruction.  With kLo false
// the value is exact in TF32 (it came from bf16) and lo is not used.
template <bool kLo>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  const uint32_t b = __float_as_uint(v);
  if (kLo) {
    hi = (b + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(v - __uint_as_float(hi));
  } else {
    hi = b;
    lo = 0u;
  }
}

// c += a * b, fp32 accumulation.  Not volatile: the compiler may
// interleave independent products.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One operand of a 3xTF32 product: its high and low TF32 parts
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// c += a * b at fp32 accuracy: the two small terms first, then hi * hi.
// A term whose low part is 0 (an operand read from bf16) is skipped.
// The tensor core adds into c with truncation, so a long chain of
// products into one c drifts toward zero (flash_attention_fwd.cu's
// kPart sums short chains into fresh fragments for that reason).
template <bool kALo, bool kBLo>
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  if (kALo) mma(c, a.lo, b.hi[0], b.hi[1]);
  if (kBLo) mma(c, a.hi, b.lo[0], b.lo[1]);
  mma(c, a.hi, b.hi[0], b.hi[1]);
}

// A fragment from a swizzled tile: rows r and r + 8, columns c, c + 1
template <int D, bool kLo, typename T>
__device__ __forceinline__ void load_a(FragA& f, const T* s, int r, int c) {
  const float2 x = ld2(s + at<D, T>(r, c));
  const float2 y = ld2(s + at<D, T>(r + 8, c));
  split<kLo>(x.x, f.hi[0], f.lo[0]);
  split<kLo>(y.x, f.hi[1], f.lo[1]);
  split<kLo>(x.y, f.hi[2], f.lo[2]);
  split<kLo>(y.y, f.hi[3], f.lo[3]);
}

// A fragment from a C fragment over the same 8 columns; with kLo false
// the values are already exact in TF32 (rounded to bf16) and carry no
// low part
template <bool kLo = true>
__device__ __forceinline__ void c_to_a(FragA& f, const float (&c)[4]) {
  split<kLo>(c[0], f.hi[0], f.lo[0]);
  split<kLo>(c[2], f.hi[1], f.lo[1]);
  split<kLo>(c[1], f.hi[2], f.lo[2]);
  split<kLo>(c[3], f.hi[3], f.lo[3]);
}

// x rounded to the nearest bf16 (ties to even), as a float: what the
// reference's `astype(bfloat16)` does to p and ds before their products
__device__ __forceinline__ float rn_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// B fragment whose n index is the tile's row: B[k][n] = tile[n][k];
// (row n, columns c, c + 1)
template <int D, bool kLo, typename T>
__device__ __forceinline__ void load_b_rows(FragB& f, const T* s, int n,
                                            int c) {
  const float2 x = ld2(s + at<D, T>(n, c));
  split<kLo>(x.x, f.hi[0], f.lo[0]);
  split<kLo>(x.y, f.hi[1], f.lo[1]);
}

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// B fragment whose k index is the tile's row: B[k][n] = tile[k][n];
// (rows k, k + 1, column n)
template <int D, bool kLo, typename T>
__device__ __forceinline__ void load_b_cols(FragB& f, const T* s, int k,
                                            int n) {
  split<kLo>(ld1(s + at<D, T>(k, n)), f.hi[0], f.lo[0]);
  split<kLo>(ld1(s + at<D, T>(k + 1, n)), f.hi[1], f.lo[1]);
}

// -- bf16 products (the forward's bf16 kernel) ------------------------------
//
// Fragments of mma.sync.m16n8k16.bf16 (g = lane / 4, t = lane % 4), each
// register a pair of neighbouring bf16 values, the lower column (or k)
// in the low half:
//   A (16 x 16): a0 (g, k 2t..2t+1), a1 (g + 8, k 2t..), a2 (g, k 2t+8..),
//                a3 (g + 8, k 2t+8..)
//   B (16 x 8):  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C (16 x 8):  as m16n8k8's, c0 (g, 2t), c1 (g, 2t+1), c2, c3 row g + 8
// The C fragments of two neighbouring 8-column steps are, rounded and
// paired, the A fragment of a 16-deep product over those columns, in
// the natural order: no permutation as in the TF32 products.  ldmatrix
// reads the fragments from the swizzled tiles: each lane gives the
// address of one 16-byte row piece (one chunk), 8 lanes an 8 x 8 matrix.

// c += a * b in bf16 with fp32 sums.  Like mma(): the tensor core's sum
// into c truncates, so long chains take fresh fragments
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// the same, each matrix transposed: lane (g, t) gets rows 2t, 2t + 1 of
// column g
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// (lo, hi) rounded to nearest even bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// an A fragment of a 16-deep step kk from the C fragments of 8-column
// steps 2kk and 2kk + 1 (p or ds of the bf16 kernels), rounded to bf16
template <int NK>
__device__ __forceinline__ void p_frag(uint32_t (&a)[4],
                                       const float (&s)[NK][4], int kk) {
  a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit; 2^-inf = 0, results below 2^-126
// flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- warpgroup products (wgmma, sm_90a) --------------------------------------
//
// wgmma.m64n64k16 over 4 warps: warp w's 16 rows of the 64 x 64 fp32
// result lie in its lanes as 8 m16n8 C fragments, d[j][e] = c_e of
// columns 8j..8j+7; a register A operand is, warp by warp, m16n8k16's
// A fragment.  Operands in shared memory are [rows][64] bf16 tiles of
// 128-byte rows, 1024-byte aligned, whose 16-byte chunks lie at c ^
// (row % 8) (the 128-byte swizzle), read through a matrix descriptor:
// start address, leading and stride byte offsets (16-byte units), the
// swizzle mode.  An operand's 8-row groups lie 1024 bytes apart (the
// stride offset).  A K-major operand (q, k: the depth along the row)
// takes its k-th 16-deep slice at start + 32k bytes; an MN-major one
// (v for p.v: the depth runs over rows) at start + 2048k bytes (16 rows),
// with one 64-column atom, so its leading offset is not read.

__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4)    // start address
         | (uint64_t)1 << 16               // leading byte offset, 16 B
         | (uint64_t)(1024 >> 4) << 32     // stride byte offset
         | (uint64_t)1 << 62;              // 128-byte swizzle
}

// the descriptor's start moved by ``bytes`` (a multiple of 16)
__device__ __forceinline__ uint64_t desc_at(uint64_t d, uint32_t bytes) {
  return d + (bytes >> 4);
}

// register writes before a wgmma that reads them, and the accumulators
// of earlier ones, are ordered by wgmma.fence
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// the compiler keeps an accumulator in place while a wgmma runs on it
__device__ __forceinline__ void keep_regs(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e]));
}

#define FLASH_WG_D32                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31}"
#define FLASH_WG_OUT(d)                                                   \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),            \
      "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),        \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),        \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),        \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),        \
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),        \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),        \
      "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])

// d (+)= A.B, 64 x 64 x 16 in bf16 with fp32 sums, A and B K-major in
// shared memory; acc = 0 overwrites d.  Asynchronous: wg_commit, then
// wg_wait_all before d is read
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      FLASH_WG_D32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FLASH_WG_OUT(d)
      : "l"(da), "l"(db), "r"(acc));
}

// the same with A in registers (m16n8k16 A fragments) and B MN-major
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[8][4],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      FLASH_WG_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FLASH_WG_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

#undef FLASH_WG_D32
#undef FLASH_WG_OUT

// 16 bytes global -> shared through L2 only; zero-filled when !valid
// (src-size 0: nothing is read)
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [r0, r0 + R) of one head's [L, D] slice into the swizzled tile s,
// by NT threads; rows at or past L are zero.  Neighbouring threads copy
// neighbouring chunks of a row, so the reads coalesce.  A tile of fewer
// chunks than threads (bf16 D = 8) leaves the last threads idle.
template <int R, int D, int NT, typename T>
__device__ __forceinline__ void cp_tile(T* s, const T* base,
                                        long long row_stride, int r0,
                                        int L) {
  constexpr int E = 16 / sizeof(T);
  constexpr int CPR = D / E;             // chunks per row
  constexpr int N = R * CPR;
  static_assert(N % NT == 0 || N < NT, "tile chunks must split evenly");
#pragma unroll
  for (int i = 0; i < (N + NT - 1) / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    if (N < NT && idx >= N) break;
    const int r = idx / CPR;
    const int c = idx - r * CPR;
    const int row = r0 + r;
    const bool ok = row < L;
    const T* src = ok ? base + row * row_stride + c * E : base;
    cp16(s + r * D + chunk_at<D, T>(r, c) * E, src, ok);
  }
}

// -- tensor-memory-accelerator copies (TMA) and their barriers ---------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// a shared-memory barrier that completes when one thread has arrived
// and the bytes it announced have landed
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// barrier initialisation made visible to the async proxy (the TMA unit)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive, announcing ``bytes`` to land before the barrier completes
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait for the barrier's phase ``parity`` to complete
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// one box of a 4-d tensor map into shared memory (the map's swizzle),
// counted against bar; rows past the tensor's extent are zero
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(smem_u32(bar))
      : "memory");
}

// -- tensor maps of the bf16 D = 64 kernels (host side) ----------------------

// cuTensorMapEncodeTiled, from the driver through the runtime (nothing
// links against the driver library)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [B][L][H][64] ('blhd': dims 64, H, L, B) or [B][H][L][64] ('bhld':
// dims 64, L, H, B; the order whose strides grow) as a map of 64-row
// boxes of one head, 128-byte swizzled; false if the driver refuses it
inline bool wg_map(CUtensorMap* map, const void* base, int B, int H,
                   int L, const Strides& st, bool blhd) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t dims[4] = {64, (cuuint64_t)(blhd ? H : L),
                              (cuuint64_t)(blhd ? L : H), (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(blhd ? st.h : st.l) * e,
                                 (cuuint64_t)(blhd ? st.l : st.h) * e,
                                 (cuuint64_t)st.b * e};
  const cuuint32_t box[4] = {64, blhd ? 1u : 64u, blhd ? 64u : 1u, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace flash
