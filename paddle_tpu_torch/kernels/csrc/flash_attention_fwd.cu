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
// +inf, so the backward's exp(s - lse) is 0 there.  In bf16 p stays
// fp32 into p.v, as in the port's plain version; the reference rounds
// the dropped p to v's dtype first, a difference below the output's
// own bf16 rounding.
//
// Bound: operations.  At the training path's shapes (B=64, L=256, H=8,
// D=64) one call does 4*B*H*L^2*D = 8.6 GFLOP (half of it under the
// causal mask).  As three TF32 products at the card's 495 TFLOP/s that
// is 0.052 ms (0.128 ms as fp32 on the CUDA cores), against 0.040 ms for
// the 134 MB that q, k, v and out move at 3.35 TB/s, which bounds the
// causal calls.
//
// Design:
//   * one block per (64-row query tile, batch*head), 4 warps, each warp
//     owning 16 query rows and all 64 keys of every key tile; the TPU's
//     serial key-block grid axis, which carried m, l and the accumulator
//     in VMEM scratch, is a loop inside the block, and the three stay in
//     registers;
//   * both products on the tensor cores at fp32 accuracy (3xTF32,
//     flash_attention_mma.cuh): s = q.k^T with q's A fragments split
//     once and kept in registers across all key tiles, k as row-wise B;
//     o += p.v with v as column-wise B.  An operand read from bf16 is
//     exact in TF32 and skips its correction product;
//   * the k permutation of flash_attention_mma.cuh makes s's C fragments
//     the A fragments of p.v: the scores stay in registers through the
//     scale, bias, mask, expf and dropout and never touch shared memory;
//   * p.v sums 32 keys at a time in a fresh fragment and adds it to the
//     output accumulator in fp32, so the tensor core's truncating
//     accumulation cannot bias the output (kPart below);
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
// Shared memory a block: two k and two v buffers, 4 x 64 x D elements:
// 65,536 bytes in fp32 at D = 64, half in bf16, less for narrow heads.
// Registers a thread: up to 255 (128 threads and two blocks an SM allow
// that); the ptxas lines of the build log, which chip_smoke.py prints,
// give each instantiation's count and its spills.

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
  uint32_t seed;
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

  // p = exp(s - m) into l; p * keep in place of s
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const float p = expf(s[j][e] - m[i]);
      l[i] += p;
      s[j][e] = kDrop ? p * keep_of(c.seed, c.bh,
                                    c.row_off + q0 + wr + g + 8 * i,
                                    c.col_off + k0 + j * 8 + 2 * t + (e & 1),
                                    c.thr, c.inv_keep)
                      : p;
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
    for (int jj = 0; jj < kPart; ++jj) c_to_a(ap[jj], s[j0 + jj]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int jj = 0; jj < kPart; ++jj) {
        FragB bv;
        load_b_cols<D, kLo>(bv, cV, (j0 + jj) * 8 + 2 * t, n * 8 + g);
        mma3<true, kLo>(part, ap[jj], bv);
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
           float rate, float inv_keep, uint32_t seed) {
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
                float rate, float inv_keep, uint32_t seed, int nc) {
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
// wrapper pads every other width up to the next of those
template <typename T>
int dispatch(int D, const FwdArgs& a, cudaStream_t stream) {
  switch (D) {
    case 8: return launch<8, T>(a, stream);
    case 16: return launch<16, T>(a, stream);
    case 32: return launch<32, T>(a, stream);
    case 64: return launch<64, T>(a, stream);
    default:
      if (D > 64 && D % 64 == 0) return launch_wide<T>(D / 64, a, stream);
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace flash

extern "C" {

// dynamic shared memory of one forward block, in bytes, for fp32 inputs
// (bf16 inputs take half): two k and two v tiles, or for D > 64 two q, k
// and v chunk tiles
size_t flash_attention_fwd_smem_bytes(int D) {
  return D > 64 ? flash::fwd_wide_smem<float>() : flash::fwd_smem<float>(D);
}

// dtype: 0 fp32, 1 bf16.  bias may be null; bias_b / bias_h are its
// leading extents (1 or B, 1 or H).  Strides are in elements.  q, k and
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
                        unsigned int seed, int dtype, void* stream) {
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
