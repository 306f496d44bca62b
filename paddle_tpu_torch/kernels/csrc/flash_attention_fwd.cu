// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of
// paddle_tpu/kernels/flash_attention.py (launched by `_pallas_forward`,
// entry `flash_attention`).  It computes what that kernel and its plain
// version `_xla_forward` compute:
//
//   q [B, Lq, H, D] ('blhd', the Transformer's layout) or [B, H, Lq, D]
//   ('bhld'); k, v likewise with Lk; fp32 or bf16, D = 8, 16, 32, 64 or
//   any multiple of 64 above it
//   bias  optional fp32 [B|1, H|1, Lq, Lk], added to the scaled scores
//   out   like q, in q's dtype;  lse [B, H, Lq] fp32
//
// Scores are q.k * sm_scale (+ bias).  A key is masked when it lies at or
// past Lk or, if causal, after the query on global positions
// (row_off + r >= col_off + c keeps it); a masked score becomes
// -0.7 * FLT_MAX.  The online softmax keeps the running max m and sum l
// per row; dropout multiplies the unnormalised p by keep_scale (the hash
// of flash_attention_common.cuh) before p.v, while l keeps the full sum.
// A row is dead when l == 0 or m <= mask / 2: its out is 0 and its lse
// +inf, so the backward's exp(s - lse) is 0 there.  In bf16 the dropped
// p is rounded to bf16 before p.v, as the reference's kernel does
// (`pd.astype(v.dtype)`), and l sums the unrounded p in fp32; in fp32 p
// stays fp32.
//
// Three kernels:
//   * fp32, and bf16 at D = 8 and above 64: `fwd_kernel` and
//     `fwd_wide_kernel`, products as 3xTF32 mma.sync (an operand read from
//     bf16 is exact in TF32 and skips its correction product; in fp32 p
//     goes into p.v split in two TF32 parts, in bf16 rounded to bf16 as
//     in the other bf16 kernels, which TF32 holds exactly);
//   * bf16 at D = 64, the Transformer's: `fwd_wg_kernel`, warpgroup
//     products (wgmma) on tiles that TMA copies in;
//   * bf16 at D = 16 and 32: `fwd_bf16_kernel`, bf16 mma.sync.m16n8k16.
//
// Bound, at the training path's shape (B=64, L=256, H=8, D=64): one call
// does 4*B*H*L^2*D = 8.6 GFLOP (about half of it under the causal
// mask).  fp32: as three TF32 products at the card's 495 TFLOP/s that is
// 0.052 ms (0.128 ms as fp32 on the CUDA cores), against 0.040 ms for
// the 134 MB that q, k, v and out move at 3.35 TB/s, which bounds the
// causal calls.  bf16: 0.0087 ms of products at 989 TFLOP/s against
// 0.020 ms for 67 MB: bytes; with dropout the hash's ~11 int32
// operations on each of the 33.5 M live scores of a full call take 0.022
// ms at the int32 rate (132 SMs x 64 lanes x 1.98 GHz), above the bytes.
//
// Design of the fp32 kernel:
//   * one block per (64-row query tile, batch*head), 4 warps, each warp
//     owning 16 query rows and all 64 keys of every key tile; the TPU's
//     serial key-block grid axis, which carried m, l and the accumulator
//     in VMEM scratch, is a loop inside the block, and the three stay in
//     registers;
//   * both products on the tensor cores at fp32 accuracy (3xTF32,
//     flash_attention_mma.cuh): s = q.k^T with q's A fragments split
//     once and kept in registers across all key tiles, k as row-wise B;
//     o += p.v with v as column-wise B;
//   * the k permutation of flash_attention_mma.cuh makes s's C fragments
//     the A fragments of p.v: the scores stay in registers through the
//     scale, bias, mask, expf and dropout and never touch shared memory;
//   * p.v sums 32 keys at a time in a fresh fragment and adds it to the
//     output accumulator in fp32, so the tensor core's truncating
//     accumulation cannot bias the output (kPart below); the bf16
//     kernels keep the same 32-key partials;
//   * the online softmax runs on the C fragments: a thread holds 2 rows
//     x 16 keys of a tile, a row's max reduces over the 4 lanes that
//     share it with two xor shuffles, and the row sum stays a per-lane
//     partial until the end;
//   * k and v come by cp.async (16 bytes a thread, L2 only) into
//     unpadded, chunk-swizzled tiles, double-buffered: the next key
//     tile's copy runs under this tile's products, and one barrier a
//     tile orders them.  q is staged once, in the second k buffer, which
//     is free until the first prefetch;
//   * the per-element work runs the same instructions for every element:
//     dropout and bias are template parameters, the causal and length
//     mask a predicate, the keep test an integer compare;
//   * key tiles wholly above the causal diagonal are skipped; ragged
//     lengths are bounds checks (copies past L zero-fill, never read).
//
// Design of the bf16 kernel at D = 64 (`fwd_wg_kernel`, below): one
// warpgroup and 64 query rows a block, as many blocks an SM as fit
// (five); q, k and v tiles by TMA, k and v double-buffered; s and p.v as
// wgmma from shared memory (p from registers); the softmax in base 2
// with the max over the unscaled scores where it may (one fused
// multiply-add and an exp a score), and the mask only on the tiles that
// need it; the output staged through shared memory into whole rows.  At
// the training shape its copies alone take most of its time (PERF.md).
//
// Heads wider than 64 (D = 64 * nc, the wrapper pads other widths up to
// the next multiple of 64) run `fwd_wide_kernel`: the D = 64 work split
// with a third grid axis over 64-column output chunks.  Each block
// streams q and k through 64-column chunk tiles, accumulating s = q.k^T
// over all nc chunks, then takes p.v over its own chunk of v: the
// scores are computed once per output chunk (nc times in all), and each
// block writes only its 64 columns of out (the block of chunk 0 writes
// lse).  Shared memory a block stays 6 x 64 x 64 elements whatever D is
// (q, k and v chunk tiles, double-buffered), so any width runs.  Speed
// at these widths is not tuned: the s product is repeated per chunk and
// q's fragments are read again every key tile.
//
// Shared memory a block (fp32 kernel): two k and two v buffers, 4 x 64 x
// D elements: 65,536 bytes in fp32 at D = 64, half in bf16, less for
// narrow heads; the bf16 D = 64 kernel 41,984.  Registers a thread: up
// to 255 (128 threads and two blocks an SM allow that; the bf16 kernels
// at most 128 for four blocks, 102 at D = 64 for five); the ptxas lines
// of the build log, which chip_smoke.py prints, give each
// instantiation's count and its spills.

#include "flash_attention_common.cuh"
#include "flash_attention_mma.cuh"

namespace flash {
namespace {

// 8-key steps of p.v that sum into one fresh fragment before an fp32
// add takes it into the output accumulator.  The tensor core's fp32
// accumulation truncates, so a chain of mma.sync into one accumulator
// shrinks it a little at every step, always toward zero: over the 96
// products of 256 keys that biased every output, and the backward's
// delta = rowsum(out * dout) carried the bias into the small, cancelling
// q and k gradients.  chip_smoke.py's card-vs-CPU training step (H100)
// measured 1.39e-3 of the largest gradient with one chain, over its
// 1e-3 limit, and 1.96e-4 with these partials.  Partials of 32 keys,
// whose signs vary, turn the bias into a random walk; of 1, 2 and 4
// k-steps a partial, 4 kept that accuracy at the least cost.
constexpr int kPart = 4;

template <typename T>
constexpr size_t fwd_smem(int D) {       // 2 x (k, v); q in the 2nd k
  return sizeof(T) * (size_t)4 * BK * D;
}

struct FwdArgs {
  const void *q, *k, *v;
  const float* bias;
  void* out;
  float* lse;
  int B, H, Lq, Lk;
  Strides sq, sk;
  int bias_b, bias_h;
  float sm_scale;
  int causal, row_off, col_off;
  float rate, inv_keep;
  const uint32_t* seed;
};

// one key tile's softmax step and p.v, shared by fwd_kernel and
// fwd_wide_kernel: s (the warp's 16 query rows x 64 keys of q.k^T, as C
// fragments) is scaled, biased and masked; the running max m and sum l
// of the thread's two rows and the accumulator acc advance; cV is the
// tile's v (a 64-column chunk of it in the wide kernel), brow the
// thread's two bias rows
template <int D, typename T, bool kDrop, bool kBias>
__device__ __forceinline__ void softmax_pv(float (&s)[BK / 8][4],
                                           float (&m)[2], float (&l)[2],
                                           float (&acc)[D / 8][4],
                                           const T* cV,
                                           const float* const* brow, int q0,
                                           int k0, const TileCtx& c) {
  constexpr bool kLo = sizeof(T) == 4;
  constexpr int NT = D / 8;
  constexpr int NK = BK / 8;
  const int wr = c.wr, g = c.g, t = c.t, Lk = c.Lk;
  // scale, bias and mask; the tile's row max over the 4 lanes of a row
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const int r = q0 + wr + g + 8 * i;
      const int col = k0 + j * 8 + 2 * t + (e & 1);
      const bool ok = live(r, col, Lk, c.causal, c.row_off, c.col_off);
      float x = s[j][e] * c.sm_scale;
      if (kBias) x += brow[i][min(col, Lk - 1)];
      x = ok ? x : kMask;
      s[j][e] = x;
      mx[i] = fmaxf(mx[i], x);
    }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = expf(m[i] - mx[i]);
    m[i] = mx[i];
    l[i] *= alpha[i];
  }

  // p = exp(s - m) into l; p * keep in place of s, rounded to bf16 for
  // bf16 inputs (the reference's `pd.astype(v.dtype)`)
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const float p = expf(s[j][e] - m[i]);
      l[i] += p;
      const float pd =
          kDrop ? p * keep_of(c.seed, c.bh, c.row_off + q0 + wr + g + 8 * i,
                              c.col_off + k0 + j * 8 + 2 * t + (e & 1),
                              c.thr, c.inv_keep)
                : p;
      s[j][e] = kLo ? pd : rn_bf16(pd);
    }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

  // o += p.v: k-step j is keys 8j..8j+7, whose p is s[j].  Each run of
  // kPart k-steps sums into a fresh fragment that an fp32 add then
  // takes into acc (see kPart)
#pragma unroll
  for (int j0 = 0; j0 < NK; j0 += kPart) {
    FragA ap[kPart];
#pragma unroll
    for (int jj = 0; jj < kPart; ++jj) c_to_a<kLo>(ap[jj], s[j0 + jj]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int jj = 0; jj < kPart; ++jj) {
        FragB bv;
        load_b_cols<D, kLo>(bv, cV, (j0 + jj) * 8 + 2 * t, n * 8 + g);
        mma3<kLo, kLo>(part, ap[jj], bv);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
    }
  }
}

template <int D, typename T, bool kDrop, bool kBias>
__global__ void __launch_bounds__(kThreads, 2)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ bias,
           T* __restrict__ out, float* __restrict__ lse, int H, int Lq,
           int Lk, Strides sq_, Strides sk_, int bias_b, int bias_h,
           float sm_scale, int causal, int row_off, int col_off,
           float rate, float inv_keep, const uint32_t* __restrict__ seed_p) {
  // the seed is read where it lies: a captured launch sees its value
  // at every replay
  const uint32_t seed = kDrop ? *seed_p : 0u;
  constexpr bool kLo = sizeof(T) == 4;   // fp32 inputs carry a low part
  constexpr int NT = D / 8;              // 8-column steps over D
  constexpr int NK = BK / 8;             // 8-column steps over a key tile
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const uint32_t thr = keep_threshold(rate);
  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's first tile row
  const int g = lane >> 2;
  const int t = lane & 3;
  const TileCtx tc{bh, wr, g, t, Lk, causal, row_off, col_off,
                   sm_scale, inv_keep, seed, thr};

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // [2][BK][D], swizzled
  T* sV = sK + 2 * BK * D;                 // [2][BK][D]
  T* sQ = sK + BK * D;                     // q, until the first prefetch

  const long long qoff = b * sq_.b + h * sq_.h;
  const long long koff = b * sk_.b + h * sk_.h;
  const int n_tiles =
      (live_keys(q0, Lq, Lk, causal, row_off, col_off) + BK - 1) / BK;

  cp_tile<BQ, D, kThreads>(sQ, q + qoff, sq_.l, q0, Lq);
  if (n_tiles > 0) {
    cp_tile<BK, D, kThreads>(sK, k + koff, sk_.l, 0, Lk);
    cp_tile<BK, D, kThreads>(sV, v + koff, sk_.l, 0, Lk);
  }
  cp_commit();
  cp_wait_all();
  __syncthreads();

  // q's A fragments, split once: rows wr + g and wr + g + 8
  FragA aq[NT];
#pragma unroll
  for (int ks = 0; ks < NT; ++ks)
    load_a<D, kLo>(aq[ks], sQ, wr + g, ks * 8 + 2 * t);

  // the bias rows of this thread's two query rows; reads are clamped
  // into the bias (a row past Lq or a key past Lk reads a neighbour's
  // value, which the mask or the store then drops)
  const float* brow[2] = {nullptr, nullptr};
  if (kBias) {
    const float* bb =
        bias + ((long long)(bias_b > 1 ? b : 0) * bias_h +
                (bias_h > 1 ? h : 0)) * (long long)Lq * Lk;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      brow[i] = bb + (long long)min(q0 + wr + g + 8 * i, Lq - 1) * Lk;
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};             // this lane's share of the sum
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    const T* cK = sK + (kt & 1) * BK * D;
    const T* cV = sV + (kt & 1) * BK * D;
    // tile kt has landed, and every warp is done with tile kt - 1 (and,
    // at kt = 0, with q), whose buffer takes tile kt + 1
    cp_wait_all();
    __syncthreads();
    if (kt + 1 < n_tiles) {
      T* nK = sK + ((kt + 1) & 1) * BK * D;
      T* nV = sV + ((kt + 1) & 1) * BK * D;
      cp_tile<BK, D, kThreads>(nK, k + koff, sk_.l, k0 + BK, Lk);
      cp_tile<BK, D, kThreads>(nV, v + koff, sk_.l, k0 + BK, Lk);
      cp_commit();
    }

    // s = q.k^T over the warp's 16 rows, 64 keys; element e of step j is
    // row g + 8 * (e / 2), key column 8j + 2t + e % 2
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < NT; ++ks)
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        FragB bk;
        load_b_rows<D, kLo>(bk, cK, j * 8 + g, ks * 8 + 2 * t);
        mma3<kLo, kLo>(s[j], aq[ks], bk);
      }

    softmax_pv<D, T, kDrop, kBias>(s, m, l, acc, cV, brow, q0, k0, tc);
  }

  T* ob = out + qoff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = q0 + wr + g + 8 * i;
    if (r >= Lq) continue;
    const bool dead = l[i] == 0.0f || m[i] <= kMask * 0.5f;
    const float inv = dead ? 0.0f : 1.0f / l[i];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      st2(ob + r * sq_.l + n * 8 + 2 * t, acc[n][2 * i] * inv,
          acc[n][2 * i + 1] * inv);
    if (t == 0)
      lse[(long long)bh * Lq + r] = dead ? INFINITY : m[i] + logf(l[i]);
  }
}

template <int D, typename T, bool kDrop, bool kBias>
int launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  const size_t smem = fwd_smem<T>(D);
  auto kernel = fwd_kernel<D, T, kDrop, kBias>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Lq + BQ - 1) / BQ, a.B * a.H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bias, static_cast<T*>(a.out), a.lse,
      a.H, a.Lq, a.Lk, a.sq, a.sk, a.bias_b, a.bias_h, a.sm_scale,
      a.causal, a.row_off, a.col_off, a.rate, a.inv_keep, a.seed);
  return (int)cudaGetLastError();
}

// dropout and bias are template parameters: no per-element branch on
// either
template <int D, typename T>
int launch(const FwdArgs& a, cudaStream_t stream) {
  if (a.rate > 0.0f)
    return a.bias ? launch_fwd<D, T, true, true>(a, stream)
                  : launch_fwd<D, T, true, false>(a, stream);
  return a.bias ? launch_fwd<D, T, false, true>(a, stream)
                : launch_fwd<D, T, false, false>(a, stream);
}

// -- the bf16 mma.sync kernel (D = 16, 32) ----------------------------------
//
// Both products as bf16 mma.sync.m16n8k16 with fp32 sums: q's A
// fragments by ldmatrix once, k's B fragments by ldmatrix, v's by
// ldmatrix.trans (p.v's depth runs over keys); p from s's C fragments,
// rounded to bf16 (p_frag).  The fp32 kernel's tiles: 4 warps of 16
// query rows, 64-key tiles, k and v double-buffered by cp.async.
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
constexpr size_t fwd_bf16_smem() {       // q, 2 x (k, v)
  return sizeof(__nv_bfloat16) * (size_t)(BQ + 4 * BK) * D;
}

// the softmax step of one key tile of the bf16 kernels, on s = q.k^T (the
// warp's 16 rows x NK 8-key steps, as C fragments): scale (to log2
// units: exp(x) = 2^(x log2 e)), bias and, where the tile needs it
// (kMasked), the mask; the running max m and sum l (of p unrounded)
// advance, alpha is the factor acc takes; s becomes p * keep.  rterm
// holds row * kRowMul of the thread's two rows, key the hash's key
// (flash_attention_common.cuh).  kRaw (no bias, sm_scale > 0, so
// scaling keeps the order): the max runs over the unscaled scores, a
// masked one -inf, and p = 2^(s * scale - m) is one fused multiply-add
// and an exp.  A row whose keys were all masked so far then keeps m =
// -inf and l = 0 where the reference keeps m at the mask value and
// counts the masked keys: it is dead either way, and its first live key
// zeroes what came before (alpha = 0) either way.
template <int NK, bool kDrop, bool kBias, bool kMasked, bool kRaw>
__device__ __forceinline__ void bf16_softmax(
    float (&s)[NK][4], float (&m)[2], float (&l)[2], float (&alpha)[2],
    const float* const (&brow)[2], const uint32_t (&rterm)[2], uint32_t key,
    int q0, int k0, const TileCtx& c) {
  static_assert(!(kRaw && kBias), "a bias needs the scaled scores");
  const int wr = c.wr, g = c.g, t = c.t, Lk = c.Lk;
  const float scale = c.sm_scale * kLog2e;
  float mx[2] = {kRaw ? -INFINITY : m[0], kRaw ? -INFINITY : m[1]};
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const int col = k0 + j * 8 + 2 * t + (e & 1);
      float x = kRaw    ? s[j][e]
                : kBias ? (s[j][e] * c.sm_scale +
                           brow[i][min(col, Lk - 1)]) * kLog2e
                        : s[j][e] * scale;
      if (kMasked)
        x = live(q0 + wr + g + 8 * i, col, Lk, c.causal, c.row_off,
                 c.col_off) ? x : (kRaw ? -INFINITY : kMask);
      s[j][e] = x;
      mx[i] = fmaxf(mx[i], x);
    }
  float mb[2];                           // the m that p subtracts
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float v = mx[i];
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    if (kRaw) v = fmaxf(v * scale, m[i]);
    mb[i] = kRaw && v == -INFINITY ? 0.0f : v;
    alpha[i] = ex2(m[i] - mb[i]);
    m[i] = v;
    l[i] *= alpha[i];
  }

  // p into l unrounded; p * keep in place of s
  const uint32_t cterm = (uint32_t)(c.col_off + k0 + 2 * t) * kColMul;
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const float p = kRaw ? ex2(fmaf(s[j][e], scale, -mb[i]))
                           : ex2(s[j][e] - mb[i]);
      l[i] += p;
      if (kDrop) {
        const uint32_t pos =
            rterm[i] + cterm + (uint32_t)(j * 8 + (e & 1)) * kColMul;
        s[j][e] = kept(pos, key, c.thr) ? p * c.inv_keep : 0.0f;
      } else {
        s[j][e] = p;
      }
    }
}

// o += p.v over one key tile of the mma.sync bf16 kernel: p (s) rounded
// to bf16 and paired into A fragments, v's B fragments by ldmatrix.trans;
// 32 keys (two 16-key steps) a fresh fragment, which an fp32 add takes
// into acc (see kPart); the tile's first also rescales acc by alpha
template <int D>
__device__ __forceinline__ void bf16_pv(const float (&s)[BK / 8][4],
                                        const float (&alpha)[2],
                                        float (&acc)[D / 8][4],
                                        const __nv_bfloat16* cV, int lane) {
  constexpr int NT = D / 8, KV = BK / 16;
  const int vr = (lane & 7) + 8 * ((lane >> 3) & 1);  // ldmatrix row
  const int vc = 8 * (lane >> 4);                      // and column
#pragma unroll
  for (int kk0 = 0; kk0 < KV; kk0 += 2) {
    uint32_t pa[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) p_frag(pa[h], s, kk0 + h);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t bv[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ldsm4_t(bv[h], cV + at<D, __nv_bfloat16>(16 * (kk0 + h) + vr,
                                                 8 * n + vc));
      float part[2][4] = {};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma16(part[0], pa[h], bv[h][0], bv[h][1]);
        mma16(part[1], pa[h], bv[h][2], bv[h][3]);
      }
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n + nn][e] = kk0 == 0 ? fmaf(acc[n + nn][e], alpha[e >> 1],
                                           part[nn][e])
                                    : acc[n + nn][e] + part[nn][e];
    }
  }
}

template <int D, bool kDrop, bool kBias>
__global__ void __launch_bounds__(kThreads, 4)
fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const float* __restrict__ bias,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                int H, int Lq, int Lk, Strides sq_, Strides sk_, int bias_b,
                int bias_h, float sm_scale, int causal, int row_off,
                int col_off, float rate, float inv_keep,
                const uint32_t* __restrict__ seed_p) {
  // the seed is read where it lies: a captured launch sees its value
  // at every replay
  const uint32_t seed = kDrop ? *seed_p : 0u;
  using T = __nv_bfloat16;
  constexpr int KS = D / 16;             // 16-deep steps of q.k^T over D
  constexpr int NK = BK / 8;             // 8-key steps of s
  constexpr int NT = D / 8;              // 8-column steps of out
  static_assert(D == 16 || D == 32, "D = 64 runs fwd_wg_kernel");
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's first row
  const int g = lane >> 2;
  const int t = lane & 3;
  const TileCtx tc{bh, wr, g, t, Lk, causal, row_off, col_off,
                   sm_scale, inv_keep, seed, keep_threshold(rate)};

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [BQ][D], swizzled
  T* sK = sQ + BQ * D;                     // [2][BK][D]
  T* sV = sK + 2 * BK * D;                 // [2][BK][D]

  const long long qoff = b * sq_.b + h * sq_.h;
  const long long koff = b * sk_.b + h * sk_.h;
  const int n_tiles =
      (live_keys(q0, Lq, Lk, causal, row_off, col_off) + BK - 1) / BK;

  cp_tile<BQ, D, kThreads>(sQ, q + qoff, sq_.l, q0, Lq);
  if (n_tiles > 0) {
    cp_tile<BK, D, kThreads>(sK, k + koff, sk_.l, 0, Lk);
    cp_tile<BK, D, kThreads>(sV, v + koff, sk_.l, 0, Lk);
  }
  cp_commit();
  cp_wait_all();
  __syncthreads();

  // q's A fragments, kept in registers across the key tiles: matrix
  // lane / 8 of ldmatrix is (rows + 8 (lane / 8 % 2), columns + 8 (lane
  // / 16)) of the 16 x 16 step
  const int ar = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int ac = 8 * (lane >> 4);
  uint32_t aq[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm4(aq[ks], sQ + at<D, T>(wr + ar, 16 * ks + ac));
  // k's B fragments of two 8-key steps: matrices (keys + 8 (lane / 16),
  // columns + 8 (lane / 8 % 2))
  const int br = (lane & 7) + 8 * (lane >> 4);
  const int bc = 8 * ((lane >> 3) & 1);

  const float* brow[2] = {};
  if (kBias) {
    const float* bb =
        bias + ((long long)(bias_b > 1 ? b : 0) * bias_h +
                (bias_h > 1 ? h : 0)) * (long long)Lq * Lk;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      brow[i] = bb + (long long)min(q0 + wr + g + 8 * i, Lq - 1) * Lk;
  }
  uint32_t rterm[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    rterm[i] = (uint32_t)(row_off + q0 + wr + g + 8 * i) * kRowMul;
  const uint32_t key = ((uint32_t)bh * kBhMul) ^ seed;

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};             // this lane's share of the sum
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  // the warp's first and last global rows
  const int row_lo = row_off + q0 + wr, row_hi = row_lo + 15;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    const T* cK = sK + (kt & 1) * BK * D;
    const T* cV = sV + (kt & 1) * BK * D;
    // tile kt has landed, and every warp is done with tile kt - 1, whose
    // buffer takes tile kt + 1
    cp_wait_all();
    __syncthreads();
    if (kt + 1 < n_tiles) {
      cp_tile<BK, D, kThreads>(sK + ((kt + 1) & 1) * BK * D, k + koff,
                               sk_.l, k0 + BK, Lk);
      cp_tile<BK, D, kThreads>(sV + ((kt + 1) & 1) * BK * D, v + koff,
                               sk_.l, k0 + BK, Lk);
      cp_commit();
    }
    // causal: every key of this tile and of the later ones lies past the
    // warp's last row.  Its masked scores would leave m, l and acc as
    // they are (p = 0, alpha = 1), or a dead row dead, so skip them
    if (causal && row_hi < col_off + k0) continue;

    // s = q.k^T over the warp's rows and the tile's keys; element e of
    // step j is row g + 8 (e / 2), key 8j + 2t + e % 2
    float s[NK][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int j = 0; j < NK; j += 2) {
        uint32_t bk[4];
        ldsm4(bk, cK + at<D, T>(8 * j + br, 16 * ks + bc));
        mma16(s[j], aq[ks], bk[0], bk[1]);
        mma16(s[j + 1], aq[ks], bk[2], bk[3]);
      }

    // the mask only where it can drop a key: past Lk, or causal keys
    // past the warp's first row
    const bool masked = k0 + BK > Lk ||
                        (causal && row_lo < col_off + k0 + BK - 1);
    float alpha[2];
    if (masked)
      bf16_softmax<NK, kDrop, kBias, true, false>(s, m, l, alpha, brow,
                                                  rterm, key, q0, k0, tc);
    else
      bf16_softmax<NK, kDrop, kBias, false, false>(s, m, l, alpha, brow,
                                                   rterm, key, q0, k0, tc);
    bf16_pv<D>(s, alpha, acc, cV, lane);
  }

  T* ob = out + qoff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int r = q0 + wr + g + 8 * i;
    if (r >= Lq) continue;
    const bool dead = sum == 0.0f || m[i] <= kMask * 0.5f;
    const float inv = dead ? 0.0f : 1.0f / sum;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      st2(ob + r * sq_.l + n * 8 + 2 * t, acc[n][2 * i] * inv,
          acc[n][2 * i + 1] * inv);
    if (t == 0)
      lse[(long long)bh * Lq + r] =
          dead ? INFINITY : fmaf(m[i], kLn2, logf(sum));
  }
}

template <int D, bool kDrop, bool kBias>
int launch_fwd_bf16(const FwdArgs& a, cudaStream_t stream) {
  const size_t smem = fwd_bf16_smem<D>();
  auto kernel = fwd_bf16_kernel<D, kDrop, kBias>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Lq + BQ - 1) / BQ, a.B * a.H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.bias,
      static_cast<__nv_bfloat16*>(a.out), a.lse, a.H, a.Lq, a.Lk, a.sq,
      a.sk, a.bias_b, a.bias_h, a.sm_scale, a.causal, a.row_off, a.col_off,
      a.rate, a.inv_keep, a.seed);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const FwdArgs& a, cudaStream_t stream) {
  if (a.rate > 0.0f)
    return a.bias ? launch_fwd_bf16<D, true, true>(a, stream)
                  : launch_fwd_bf16<D, true, false>(a, stream);
  return a.bias ? launch_fwd_bf16<D, false, true>(a, stream)
                : launch_fwd_bf16<D, false, false>(a, stream);
}

// -- the bf16 kernel at D = 64: warpgroup products, TMA copies --------------
//
// One warpgroup (4 warps) a block, 64 query rows, 64-key tiles.  s =
// q.k^T is four wgmma.m64n64k16 with q and k read from shared memory
// through descriptors; o += p.v four more with p in registers (rounded
// to bf16 from s's accumulators) and v read from shared memory MN-major,
// 32 keys a fresh accumulator (see kPart), one reused after a wait.  q,
// k and v come by TMA (one thread issues a tile's copy; a barrier in
// shared memory counts its bytes) into tiles of the 128-byte swizzle
// that wgmma reads; k and v stream through a ring of kWgStages slots,
// kWgStages - 1 tiles in flight while one is in use.  A head's query
// tiles run last first: under the causal mask the later ones see more
// keys, and the longest blocks start first.  The output tile goes out
// through the q slot, in whole 128-byte rows.  Two ring slots and five
// blocks an SM measured fastest at the training shape (PERF.md).
constexpr int kWgStages = 2;
constexpr int kWgRows = BQ;  // the query tile that live_keys counts
constexpr int kWgKeys = 64;
constexpr int kWgThreads = 128;
constexpr uint32_t kWgTileBytes = kWgKeys * 64 * sizeof(__nv_bfloat16);

constexpr size_t fwd_wg_smem() {  // q, the k and v rings, barriers, align
  return (size_t)(1 + 2 * kWgStages) * kWgTileBytes + 8 * kWgStages + 1024;
}

// the three tensor maps of a call: q, k, v as 4-d [B][., .][64] boxes of
// 64 rows of one head
struct WgMaps {
  CUtensorMap q, k, v;
};

template <bool kDrop, bool kBias, bool kRaw>
__global__ void __launch_bounds__(kWgThreads, 5)
fwd_wg_kernel(const __grid_constant__ WgMaps maps, int q_blhd, int kv_blhd,
              const float* __restrict__ bias,
              __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H,
              int Lq, int Lk, Strides sq_, int bias_b, int bias_h,
              float sm_scale, int causal, int row_off, int col_off,
              float rate, float inv_keep, const uint32_t* __restrict__ seed_p) {
  // the seed is read where it lies: a captured launch sees its value
  // at every replay
  const uint32_t seed = kDrop ? *seed_p : 0u;
  using T = __nv_bfloat16;
  constexpr int D = 64, BQw = kWgRows, BKw = kWgKeys, NK = BKw / 8;
  constexpr int NS = kWgStages;
  constexpr int TILE = BKw * D;          // elements of a q, k or v tile
  constexpr uint32_t kTileDesc = kWgTileBytes >> 4;  // desc units
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQw;
  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's first row
  const int g = lane >> 2;
  const int t = lane & 3;
  const TileCtx tc{bh, wr, g, t, Lk, causal, row_off, col_off,
                   sm_scale, inv_keep, seed, keep_threshold(rate)};

  extern __shared__ unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(
      ((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);  // [64][64]
  T* sK = sQ + TILE;                     // [NS][64][64]
  T* sV = sK + NS * TILE;                // [NS][64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + NS * TILE);  // [NS]

  const int n_tiles =
      (live_keys(q0, Lq, Lk, causal, row_off, col_off) + BKw - 1) / BKw;
  // rows r0.. of this head in a map of either order (wg_map)
  auto load = [&](T* dst, const CUtensorMap* map, uint64_t* bar, int r0,
                  int blhd) {
    if (blhd)
      tma_load(dst, map, bar, 0, h, r0, b);
    else
      tma_load(dst, map, bar, 0, r0, h, b);
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < NS; ++st) mbar_init(full + st);
    mbar_init_fence();
    // tile 0 with q, then the ring's other slots
#pragma unroll
    for (int st = 0; st < NS - 1; ++st)
      if (st < n_tiles) {
        mbar_expect(full + st, (st == 0 ? 3 : 2) * kWgTileBytes);
        if (st == 0) load(sQ, &maps.q, full, q0, q_blhd);
        load(sK + st * TILE, &maps.k, full + st, st * BKw, kv_blhd);
        load(sV + st * TILE, &maps.v, full + st, st * BKw, kv_blhd);
      }
  }
  __syncthreads();                       // the barriers are initialised
  const uint64_t dq = sw128_desc(sQ);
  const uint64_t dk0 = sw128_desc(sK), dv0 = sw128_desc(sV);

  const float* brow[2] = {};
  if (kBias) {
    const float* bb =
        bias + ((long long)(bias_b > 1 ? b : 0) * bias_h +
                (bias_h > 1 ? h : 0)) * (long long)Lq * Lk;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      brow[i] = bb + (long long)min(q0 + wr + g + 8 * i, Lq - 1) * Lk;
  }
  uint32_t rterm[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    rterm[i] = (uint32_t)(row_off + q0 + wr + g + 8 * i) * kRowMul;
  const uint32_t key = ((uint32_t)bh * kBhMul) ^ seed;

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};             // this lane's share of the sum
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  const int row_lo = row_off + q0 + wr;  // the warp's first global row
  // s = q.k^T of tile kt, issued (wg_commit, wg_wait to read it)
  auto qk = [&](float (&sx)[NK][4], int kt) {
    const uint32_t off = (kt % NS) * kTileDesc;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss(sx, desc_at(dq, 32 * ks), desc_at(dk0 + off, 32 * ks), ks);
  };
  // the softmax step of tile kt, p rounded into A fragments
  auto softmax = [&](float (&sx)[NK][4], int kt, float (&al)[2],
                     uint32_t (&pa)[4][4]) {
    const int k0 = kt * BKw;
    const bool masked = k0 + BKw > Lk ||
                        (causal && row_lo < col_off + k0 + BKw - 1);
    if (masked)
      bf16_softmax<NK, kDrop, kBias, true, kRaw>(
          sx, m, l, al, brow, rterm, key, q0, k0, tc);
    else
      bf16_softmax<NK, kDrop, kBias, false, kRaw>(
          sx, m, l, al, brow, rterm, key, q0, k0, tc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) p_frag(pa[kk], sx, kk);
  };
  int slot = 0;                          // tile kt's ring slot
  uint32_t parity = 0;                   // and its barrier's phase
  for (int kt = 0; kt < n_tiles; ++kt) {
    // every warp is done with tile kt - 1, whose slot takes tile kt +
    // NS - 1
    if (kt > 0) __syncthreads();
    const int nt = kt + NS - 1;
    if (threadIdx.x == 0 && nt < n_tiles) {
      const int ns = slot == 0 ? NS - 1 : slot - 1;
      mbar_expect(full + ns, 2 * kWgTileBytes);
      load(sK + ns * TILE, &maps.k, full + ns, nt * BKw, kv_blhd);
      load(sV + ns * TILE, &maps.v, full + ns, nt * BKw, kv_blhd);
    }
    mbar_wait(full + slot, parity);      // tile kt has landed
    const uint32_t off = slot * kTileDesc;
    if (++slot == NS) {
      slot = 0;
      parity ^= 1;
    }

    float s[NK][4];
    wg_fence();
    qk(s, kt);
    wg_commit();
    wg_wait_all();
    keep_regs(s);
    float alpha[2];
    uint32_t pa[4][4];
    softmax(s, kt, alpha, pa);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {     // keys 32 h2 .. 32 h2 + 31
      float part[8][4];
      wg_fence();
#pragma unroll
      for (int kk = 2 * h2; kk < 2 * h2 + 2; ++kk)
        wgmma_rs_mn(part, pa[kk], desc_at(dv0 + off, 2048 * kk), kk & 1);
      wg_commit();
      wg_wait_all();
      keep_regs(part);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = h2 == 0 ? fmaf(acc[n][e], alpha[e >> 1], part[n][e])
                              : acc[n][e] + part[n][e];
    }
  }

  // out through the q tile's slot, as q was laid out there, then to
  // memory in whole 128-byte rows, 16 bytes a thread
  T* ob = out + b * sq_.b + h * sq_.h;
  __syncthreads();                       // every warp is done with q
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int r = wr + g + 8 * i;        // row of the tile
    const bool dead = sum == 0.0f || m[i] <= kMask * 0.5f;
    const float inv = dead ? 0.0f : 1.0f / sum;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      st2(sQ + r * D + ((n ^ (r & 7)) << 3) + 2 * t, acc[n][2 * i] * inv,
          acc[n][2 * i + 1] * inv);
    if (t == 0 && q0 + r < Lq)
      lse[(long long)bh * Lq + q0 + r] =
          dead ? INFINITY : fmaf(m[i], kLn2, logf(sum));
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < BQw * 8 / kWgThreads; ++i) {
    const int idx = threadIdx.x + i * kWgThreads;
    const int r = idx >> 3, c = idx & 7;
    if (q0 + r < Lq)
      *reinterpret_cast<uint4*>(ob + (q0 + r) * sq_.l + c * 8) =
          *reinterpret_cast<const uint4*>(sQ + r * D + ((c ^ (r & 7)) << 3));
  }
}

template <bool kDrop, bool kBias, bool kRaw>
int launch_fwd_wg(const FwdArgs& a, cudaStream_t stream) {
  const size_t smem = fwd_wg_smem();
  auto kernel = fwd_wg_kernel<kDrop, kBias, kRaw>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool q_blhd = a.sq.h <= a.sq.l, kv_blhd = a.sk.h <= a.sk.l;
  WgMaps maps;
  if (!wg_map(&maps.q, a.q, a.B, a.H, a.Lq, a.sq, q_blhd) ||
      !wg_map(&maps.k, a.k, a.B, a.H, a.Lk, a.sk, kv_blhd) ||
      !wg_map(&maps.v, a.v, a.B, a.H, a.Lk, a.sk, kv_blhd))
    return (int)cudaErrorInvalidValue;
  dim3 grid((a.Lq + kWgRows - 1) / kWgRows, a.B * a.H);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      maps, (int)q_blhd, (int)kv_blhd, a.bias,
      static_cast<__nv_bfloat16*>(a.out), a.lse, a.H, a.Lq, a.Lk, a.sq,
      a.bias_b, a.bias_h, a.sm_scale, a.causal, a.row_off, a.col_off, a.rate,
      a.inv_keep, a.seed);
  return (int)cudaGetLastError();
}

// the max over unscaled scores where no bias is added and the scale
// keeps their order
template <bool kDrop>
int launch_wg_drop(const FwdArgs& a, cudaStream_t stream) {
  if (a.bias) return launch_fwd_wg<kDrop, true, false>(a, stream);
  return a.sm_scale > 0.0f ? launch_fwd_wg<kDrop, false, true>(a, stream)
                           : launch_fwd_wg<kDrop, false, false>(a, stream);
}

int launch_wg(const FwdArgs& a, cudaStream_t stream) {
  return a.rate > 0.0f ? launch_wg_drop<true>(a, stream)
                       : launch_wg_drop<false>(a, stream);
}

// D = 64 * nc: one block per (query tile, batch*head, 64-column output
// chunk oc).  A stage is one (key tile, input chunk): it copies that
// chunk of the q tile and of the key tile (and, at the key tile's last
// chunk, chunk oc of its v) into one of two buffers while the previous
// stage's products run.  s sums over the nc chunks in registers; at a
// key tile's last chunk the softmax and p.v run as in fwd_kernel.
template <typename T>
constexpr size_t fwd_wide_smem() {      // 2 x (q, k, v) chunk tiles
  return sizeof(T) * (size_t)2 * (BQ + 2 * BK) * 64;
}

template <typename T, bool kDrop, bool kBias>
__global__ void __launch_bounds__(kThreads, 2)
fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ bias,
                T* __restrict__ out, float* __restrict__ lse, int H, int Lq,
                int Lk, Strides sq_, Strides sk_, int bias_b, int bias_h,
                float sm_scale, int causal, int row_off, int col_off,
                float rate, float inv_keep,
                const uint32_t* __restrict__ seed_p, int nc) {
  // the seed is read where it lies: a captured launch sees its value
  // at every replay
  const uint32_t seed = kDrop ? *seed_p : 0u;
  constexpr int D = 64;                  // the chunk width
  constexpr bool kLo = sizeof(T) == 4;
  constexpr int NT = D / 8;
  constexpr int NK = BK / 8;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const int oc = blockIdx.z;
  const uint32_t thr = keep_threshold(rate);
  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2;
  const int t = lane & 3;
  const TileCtx tc{bh, wr, g, t, Lk, causal, row_off, col_off,
                   sm_scale, inv_keep, seed, thr};

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [2][BQ][64], swizzled
  T* sK = sQ + 2 * BQ * D;                 // [2][BK][64]
  T* sV = sK + 2 * BK * D;                 // [2][BK][64]

  const long long qoff = b * sq_.b + h * sq_.h;
  const long long koff = b * sk_.b + h * sk_.h;
  const int n_tiles =
      (live_keys(q0, Lq, Lk, causal, row_off, col_off) + BK - 1) / BK;
  const int n_stages = n_tiles * nc;

  // copy stage st (key tile st / nc, chunk st % nc) into buffer st & 1
  auto copy_stage = [&](int st) {
    const int kt = st / nc, c = st - kt * nc, buf = st & 1;
    cp_tile<BQ, D, kThreads>(sQ + buf * BQ * D, q + qoff + c * D, sq_.l, q0,
                             Lq);
    cp_tile<BK, D, kThreads>(sK + buf * BK * D, k + koff + c * D, sk_.l,
                             kt * BK, Lk);
    if (c == nc - 1)
      cp_tile<BK, D, kThreads>(sV + buf * BK * D, v + koff + oc * D, sk_.l,
                               kt * BK, Lk);
    cp_commit();
  };
  if (n_stages > 0) copy_stage(0);

  const float* brow[2] = {nullptr, nullptr};
  if (kBias) {
    const float* bb =
        bias + ((long long)(bias_b > 1 ? b : 0) * bias_h +
                (bias_h > 1 ? h : 0)) * (long long)Lq * Lk;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      brow[i] = bb + (long long)min(q0 + wr + g + 8 * i, Lq - 1) * Lk;
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float s[NK][4];

  for (int st = 0; st < n_stages; ++st) {
    const int kt = st / nc, c = st - kt * nc, buf = st & 1;
    const T* cQ = sQ + buf * BQ * D;
    const T* cK = sK + buf * BK * D;
    // stage st has landed, and every warp is done with stage st - 1,
    // whose buffer takes stage st + 1
    cp_wait_all();
    __syncthreads();
    if (st + 1 < n_stages) copy_stage(st + 1);

    if (c == 0) {
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    }
#pragma unroll
    for (int ks = 0; ks < NT; ++ks) {
      FragA aq;
      load_a<D, kLo>(aq, cQ, wr + g, ks * 8 + 2 * t);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        FragB bk;
        load_b_rows<D, kLo>(bk, cK, j * 8 + g, ks * 8 + 2 * t);
        mma3<kLo, kLo>(s[j], aq, bk);
      }
    }
    if (c != nc - 1) continue;

    softmax_pv<D, T, kDrop, kBias>(s, m, l, acc, sV + buf * BK * D, brow,
                                   q0, kt * BK, tc);
  }

  T* ob = out + qoff + oc * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = q0 + wr + g + 8 * i;
    if (r >= Lq) continue;
    const bool dead = l[i] == 0.0f || m[i] <= kMask * 0.5f;
    const float inv = dead ? 0.0f : 1.0f / l[i];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      st2(ob + r * sq_.l + n * 8 + 2 * t, acc[n][2 * i] * inv,
          acc[n][2 * i + 1] * inv);
    if (t == 0 && oc == 0)
      lse[(long long)bh * Lq + r] = dead ? INFINITY : m[i] + logf(l[i]);
  }
}

template <typename T, bool kDrop, bool kBias>
int launch_fwd_wide(int nc, const FwdArgs& a, cudaStream_t stream) {
  const size_t smem = fwd_wide_smem<T>();
  auto kernel = fwd_wide_kernel<T, kDrop, kBias>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Lq + BQ - 1) / BQ, a.B * a.H, nc);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bias, static_cast<T*>(a.out), a.lse,
      a.H, a.Lq, a.Lk, a.sq, a.sk, a.bias_b, a.bias_h, a.sm_scale,
      a.causal, a.row_off, a.col_off, a.rate, a.inv_keep, a.seed, nc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wide(int nc, const FwdArgs& a, cudaStream_t stream) {
  if (a.rate > 0.0f)
    return a.bias ? launch_fwd_wide<T, true, true>(nc, a, stream)
                  : launch_fwd_wide<T, true, false>(nc, a, stream);
  return a.bias ? launch_fwd_wide<T, false, true>(nc, a, stream)
                : launch_fwd_wide<T, false, false>(nc, a, stream);
}

// the head widths of the repo's configurations and the reference's
// kernel tests, and any multiple of 64 above them (the wide kernel); the
// wrapper pads every other width up to the next of those.  bf16 at
// D = 16, 32 and 64 runs the bf16 kernel; bf16 at D = 8 (under
// m16n8k16's depth of 16) and above 64 the TF32 kernels
template <typename T>
int dispatch(int D, const FwdArgs& a, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  switch (D) {
    case 8: return launch<8, T>(a, stream);
    case 16:
      if constexpr (kBf16) return launch_bf16<16>(a, stream);
      else return launch<16, T>(a, stream);
    case 32:
      if constexpr (kBf16) return launch_bf16<32>(a, stream);
      else return launch<32, T>(a, stream);
    case 64:
      if constexpr (kBf16) return launch_wg(a, stream);
      else return launch<64, T>(a, stream);
    default:
      if (D > 64 && D % 64 == 0) return launch_wide<T>(D / 64, a, stream);
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace flash

extern "C" {

// dynamic shared memory of one forward block, in bytes, the larger of
// the fp32 and bf16 kernels': two k and two v tiles (and, in bf16, the q
// tile), or for D > 64 two q, k and v chunk tiles
size_t flash_attention_fwd_smem_bytes(int D) {
  if (D > 64) return flash::fwd_wide_smem<float>();
  const size_t f32 = flash::fwd_smem<float>(D);
  const size_t bf16 = D == 16   ? flash::fwd_bf16_smem<16>()
                      : D == 32 ? flash::fwd_bf16_smem<32>()
                      : D == 64 ? flash::fwd_wg_smem()
                                : 0;
  return f32 > bf16 ? f32 : bf16;
}

// dtype: 0 fp32, 1 bf16.  bias may be null; bias_b / bias_h are its
// leading extents (1 or B, 1 or H).  seed points at the uint32 dropout
// seed on the card, read by the kernel when rate > 0 (null otherwise),
// so a CUDA graph that captured the launch reads it anew at each
// replay.  Strides are in elements.  q, k and
// v must start on a 16-byte boundary with their rows (D elements)
// contiguous: tiles are copied in 16-byte pieces.  Returns the CUDA
// error of the launch (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const float* bias, void* out, float* lse, int B,
                        int H, int Lq, int Lk, int D, long long q_sb,
                        long long q_sh, long long q_sl, long long k_sb,
                        long long k_sh, long long k_sl, int bias_b,
                        int bias_h, float sm_scale, int causal, int row_off,
                        int col_off, float rate, float inv_keep,
                        const unsigned int* seed, int dtype, void* stream) {
  const flash::FwdArgs a{q,        k,      v,       bias,    out,
                         lse,      B,      H,       Lq,      Lk,
                         {q_sb, q_sh, q_sl}, {k_sb, k_sh, k_sl},
                         bias_b,   bias_h, sm_scale, causal, row_off,
                         col_off,  rate,   inv_keep, seed};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return flash::dispatch<float>(D, a, st);
  if (dtype == 1) return flash::dispatch<__nv_bfloat16>(D, a, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
