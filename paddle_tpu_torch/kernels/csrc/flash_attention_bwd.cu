// Flash-attention backward for Hopper (sm_90a): two kernels, dq and
// dk/dv.
//
// `dq_kernel` replaces the TPU kernel `_dq_kernel` and `dkv_kernel` the
// TPU kernel `_dkv_kernel` of paddle_tpu/kernels/flash_attention.py (both
// launched by `_pallas_backward`, entry `flash_attention`).  They compute
// what those kernels and the plain `_xla_backward` compute, bias-free:
//
//   q, k, v, out, dout  as in the forward ('blhd' or 'bhld', fp32 or bf16,
//                       D = 8, 16, 32, 64 or any multiple of 64 above)
//   lse [B, H, Lq] fp32, +inf on dead rows
//   dq like q, dk and dv like k, in the input dtype
//
// p is recomputed from the saved lse, p = exp(s - lse), under the same
// masks as the forward; delta = rowsum(out * dout) is formed in the
// kernel from the (dropped) output, once per query tile.  With dropout,
// dp is multiplied by the forward's keep_scale; dv takes p * keep and dk
// and dq take ds = p * (dp * keep - delta) * sm_scale.  With a bias the
// backward is the plain one, as the reference routes it (it has no
// bias-carrying backward kernel and dbias needs the [Lq, Lk] shape).
//
// Bound: operations.  At B=64, L=256, H=8, D=64, dq recomputes s and dp
// and forms dq, 6*B*H*L^2*D = 12.9 GFLOP; dk/dv forms s, dp, dv and dk,
// 8*B*H*L^2*D = 17.2 GFLOP; half of each under the causal mask.  Done as
// three TF32 products each at the card's 495 TFLOP/s that is 0.078 and
// 0.104 ms (0.19 and 0.26 ms as fp32 on the CUDA cores).  The bytes (q,
// k, v, out, dout, lse read once, the gradients written once) take under
// 0.07 ms at 3.35 TB/s.
//
// Design:
//   * dq: one block per (64-row query tile, batch*head) looping over key
//     tiles; dk/dv: one block per (64-row key tile, batch*head) looping
//     over query tiles -- the TPU's serial grid axes become these loops,
//     the accumulators sit in registers instead of VMEM scratch.  Two
//     passes and no atomics, so the gradients are the same from run to
//     run;
//   * 4 warps a block, each owning 16 rows of the block's tile (query
//     rows in dq, key rows in dk/dv) and all 64 columns of every product
//     over them;
//   * every product on the tensor cores at fp32 accuracy (3xTF32): each
//     operand is split into a rounded TF32 high part and the exact rest,
//     and c += lo*hi + hi*lo + hi*hi with mma.sync m16n8k8 into one fp32
//     accumulator (flash_attention_mma.cuh).  An operand read from a
//     bf16 tensor is exact in TF32, so its correction product is skipped.
//     mma.sync, not wgmma: wgmma takes TF32 operands only K-major from
//     shared memory, which dS^T.Q and P^T.dO are not;
//   * the k index of every product is permuted within its 8-column step
//     (flash_attention_mma.cuh), so the score and dp fragments of one
//     product are the A fragments of the next: s and dp stay in
//     registers through the mask, expf, the dropout hash and ds, and go
//     into dq += ds.k, dv += (p*keep)^T.do and dk += ds^T.q without a
//     trip through shared memory;
//   * tiles come by cp.async (16 bytes a thread, L2 only) into unpadded
//     tiles whose 16-byte chunks are XOR-swizzled, so the copies and all
//     fragment loads are free of bank conflicts; rows past L are
//     zero-filled, never read.  dq double-buffers k and v, dk/dv q, do
//     and the next tile's out: the next tile's copy runs under this
//     tile's products, and one barrier a tile (two in dk/dv, around
//     delta) orders them;
//   * the per-element work (mask, expf, dropout hash, ds) runs the same
//     instructions for every element: dropout is a template parameter,
//     the mask a predicate, the keep test an integer compare;
//   * tiles wholly above the causal diagonal are skipped; ragged lengths
//     are bounds checks (rows past Lq get lse = +inf, so p = 0).
//
// Heads wider than 64 (D = 64 * nc; the wrapper pads other widths up to
// the next multiple of 64) run `dq_wide_kernel` and `dkv_wide_kernel`:
// the same work split with a third grid axis over 64-column output
// chunks.  A block streams every 64-column chunk of its operands through
// double-buffered chunk tiles, one (tile, chunk) stage at a time,
// accumulating s and dp over all nc chunks in registers; the chunks are
// taken in the order oc + 1, ..., oc (mod nc), so the last stage leaves
// chunk oc of k (dq) or of q and do (dk/dv) in shared memory for the
// block's own output product.  delta = rowsum(out * dout) sums over the
// chunks too: once before the key loop in dq, per query tile from the
// stages' out chunks in dk/dv.  Shared memory stays that of 64-wide
// tiles whatever D is, so any width runs; s and dp are recomputed per
// output chunk, and speed at these widths is not tuned.
//
// Shared memory a block at D = 64 (fp32; bf16 half of it; narrower heads
// in proportion), two blocks an SM:
//   dq:    q, do and two k, v buffers, 6 x 16 KB = 98,304 bytes;
//   dk/dv: k, v, two q, do buffers and out, 7 x 16 KB, plus lse and
//          delta of the query tile: 115,200 bytes.
// Registers a thread: up to 255 (128 threads and two blocks an SM allow
// that); the ptxas lines of the build log, which chip_smoke.py prints,
// give each instantiation's count and its spills.

#include "flash_attention_common.cuh"
#include "flash_attention_mma.cuh"

namespace flash {
namespace {

template <typename T>
constexpr size_t dq_smem(int D) {        // q, do, 2 x (k, v)
  return sizeof(T) * (size_t)(2 * BQ + 4 * BK) * D;
}
template <typename T>
constexpr size_t dkv_smem(int D) {       // k, v, 2 x (q, do), out; lse, delta
  return sizeof(T) * (size_t)(2 * BK + 5 * BQ) * D + 2 * BQ * sizeof(float);
}

// rowsum(out * dout) of tile row r, each of a lane pair (r, half) taking
// half of the D columns; both lanes of the pair return the row's sum
template <int D, typename T>
__device__ __forceinline__ float row_delta(const T* sO, const T* sdO, int r,
                                           int half) {
  float acc = 0.0f;
#pragma unroll
  for (int c = half * D / 2; c < (half + 1) * D / 2; c += 2) {
    const float2 o = ld2(sO + at<D, T>(r, c));
    const float2 d = ld2(sdO + at<D, T>(r, c));
    acc = fmaf(o.x, d.x, acc);
    acc = fmaf(o.y, d.y, acc);
  }
  return acc + __shfl_xor_sync(0xffffffffu, acc, 1);
}

// x += a1.b1^T and y += a2.b2^T: the warp's 16 rows (wr + g, + 8) of
// the [64][D] tiles a1 and a2 against all 64 rows of b1 and b2, as C
// fragments (s and dp in dq; s^T and dp^T in dk/dv)
template <int D, typename T>
__device__ __forceinline__ void score_pair(float (&x)[8][4], float (&y)[8][4],
                                           const T* a1, const T* a2,
                                           const T* b1, const T* b2, int wr,
                                           int g, int t) {
  constexpr bool kLo = sizeof(T) == 4;
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    const int c = ks * 8 + 2 * t;
    FragA f1, f2;
    load_a<D, kLo>(f1, a1, wr + g, c);
    load_a<D, kLo>(f2, a2, wr + g, c);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      FragB h1, h2;
      load_b_rows<D, kLo>(h1, b1, j * 8 + g, c);
      load_b_rows<D, kLo>(h2, b2, j * 8 + g, c);
      mma3<kLo, kLo>(x[j], f1, h1);
      mma3<kLo, kLo>(y[j], f2, h2);
    }
  }
}

// dq's step for one key tile at k0: ds from s and dp in place of s (row
// q0 + wr + g + 8 * (e / 2), key column k0 + 8j + 2t + e % 2), then
// acc += ds.k, k-step j being keys 8j..8j+7; cK is the tile's k (a
// 64-column chunk of it in the wide kernel)
template <int D, typename T, bool kDrop>
__device__ __forceinline__ void dq_step(float (&s)[8][4],
                                        const float (&dp)[8][4],
                                        float (&acc)[D / 8][4], const T* cK,
                                        const float (&lse_r)[2],
                                        const float (&delta_r)[2], int q0,
                                        int k0, const TileCtx& c) {
  constexpr bool kLo = sizeof(T) == 4;
  const int wr = c.wr, g = c.g, t = c.t;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = q0 + wr + g + 8 * (e >> 1);
      const int col = k0 + j * 8 + 2 * t + (e & 1);
      const float x = live(r, col, c.Lk, c.causal, c.row_off, c.col_off)
                          ? s[j][e] * c.sm_scale : kMask;
      const float p = expf(x - lse_r[e >> 1]);
      float gd = dp[j][e];
      if (kDrop)
        gd *= keep_of(c.seed, c.bh, c.row_off + r, c.col_off + col, c.thr,
                      c.inv_keep);
      s[j][e] = p * (gd - delta_r[e >> 1]) * c.sm_scale;
    }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    FragA ads;
    c_to_a(ads, s[j]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      FragB bk;
      load_b_cols<D, kLo>(bk, cK, j * 8 + 2 * t, n * 8 + g);
      mma3<true, kLo>(acc[n], ads, bk);
    }
  }
}

// dk/dv's step for one query tile at q0: p * keep in place of s^T and ds
// in place of dp^T (key row k0 + wr + g + 8 * (e / 2), query column
// 8j + 2t + e % 2, whose lse and delta are sL and sD), then
// dv += (p*keep)^T.do and dk += ds^T.q, k-step j being queries
// 8j..8j+7; cQ and cdO are the tile's q and do (64-column chunks of them
// in the wide kernel)
template <int D, typename T, bool kDrop>
__device__ __forceinline__ void dkv_step(float (&st)[8][4],
                                         float (&dpt)[8][4],
                                         float (&dk_acc)[D / 8][4],
                                         float (&dv_acc)[D / 8][4],
                                         const T* cQ, const T* cdO,
                                         const float* sL, const float* sD,
                                         int q0, int k0, const TileCtx& c) {
  constexpr bool kLo = sizeof(T) == 4;
  const int wr = c.wr, g = c.g, t = c.t;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + wr + g + 8 * (e >> 1);   // key position
      const int lq = j * 8 + 2 * t + (e & 1);
      const int r = q0 + lq;                         // query position
      const float x = live(r, col, c.Lk, c.causal, c.row_off, c.col_off)
                          ? st[j][e] * c.sm_scale : kMask;
      const float p = expf(x - sL[lq]);
      const float keep =
          kDrop ? keep_of(c.seed, c.bh, c.row_off + r, c.col_off + col,
                          c.thr, c.inv_keep)
                : 1.0f;
      st[j][e] = p * keep;
      dpt[j][e] = p * (dpt[j][e] * keep - sD[lq]) * c.sm_scale;
    }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    FragA ap, ads;
    c_to_a(ap, st[j]);
    c_to_a(ads, dpt[j]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      FragB bo, bq;
      load_b_cols<D, kLo>(bo, cdO, j * 8 + 2 * t, n * 8 + g);
      load_b_cols<D, kLo>(bq, cQ, j * 8 + 2 * t, n * 8 + g);
      mma3<true, kLo>(dv_acc[n], ap, bo);
      mma3<true, kLo>(dk_acc[n], ads, bq);
    }
  }
}

template <int D, typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ out,
          const T* __restrict__ dout, const float* __restrict__ lse,
          T* __restrict__ dq, int H, int Lq, int Lk, Strides sq_,
          Strides sk_, float sm_scale, int causal, int row_off, int col_off,
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
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [BQ][D], swizzled
  T* sdO = sQ + BQ * D;                    // [BQ][D]
  T* sK = sdO + BQ * D;                    // [2][BK][D]
  T* sV = sK + 2 * BK * D;                 // [2][BK][D]

  const long long qoff = b * sq_.b + h * sq_.h;
  const long long koff = b * sk_.b + h * sk_.h;

  const int n_keys = live_keys(q0, Lq, Lk, causal, row_off, col_off);
  const int n_tiles = (n_keys + BK - 1) / BK;

  // q, do, the out rows (into the second k buffer, free until the first
  // prefetch) and the first k, v tile
  cp_tile<BQ, D, kThreads>(sQ, q + qoff, sq_.l, q0, Lq);
  cp_tile<BQ, D, kThreads>(sdO, dout + qoff, sq_.l, q0, Lq);
  cp_tile<BQ, D, kThreads>(sK + BK * D, out + qoff, sq_.l, q0, Lq);
  if (n_tiles > 0) {
    cp_tile<BK, D, kThreads>(sK, k + koff, sk_.l, 0, Lk);
    cp_tile<BK, D, kThreads>(sV, v + koff, sk_.l, 0, Lk);
  }
  cp_commit();

  // lse and delta of this thread's rows g and g + 8 of the warp's 16
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + wr + g + 8 * i;
    lse_r[i] = r < Lq ? lse[(long long)bh * Lq + r] : INFINITY;
  }
  cp_wait_all();
  __syncthreads();
  {
    const float d = row_delta<D>(sK + BK * D, sdO, wr + (lane >> 1),
                                 lane & 1);
    delta_r[0] = __shfl_sync(0xffffffffu, d, 2 * g);
    delta_r[1] = __shfl_sync(0xffffffffu, d, 2 * g + 16);
  }

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
    // at kt = 0, with the out rows), whose buffer takes tile kt + 1
    cp_wait_all();
    __syncthreads();
    if (kt + 1 < n_tiles) {
      T* nK = sK + ((kt + 1) & 1) * BK * D;
      T* nV = sV + ((kt + 1) & 1) * BK * D;
      cp_tile<BK, D, kThreads>(nK, k + koff, sk_.l, k0 + BK, Lk);
      cp_tile<BK, D, kThreads>(nV, v + koff, sk_.l, k0 + BK, Lk);
      cp_commit();
    }

    // s = q.k^T and dp = do.v^T over the warp's 16 rows, 64 keys
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    score_pair<D>(s, dp, sQ, sdO, cK, cV, wr, g, t);
    dq_step<D, T, kDrop>(s, dp, acc, cK, lse_r, delta_r, q0, k0, tc);
  }

  T* dqb = dq + qoff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + wr + g + 8 * i;
    if (r >= Lq) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      st2(dqb + r * sq_.l + n * 8 + 2 * t, acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// the warp owns key rows wr..wr+15 of the block's tile; the score tile is
// transposed, s^T [keys][queries], so its C fragments are the A fragments
// of dv += (p*keep)^T.do and dk += ds^T.q
template <int D, typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ out,
           const T* __restrict__ dout, const float* __restrict__ lse,
           T* __restrict__ dk, T* __restrict__ dv, int H, int Lq, int Lk,
           Strides sq_, Strides sk_, float sm_scale, int causal,
           int row_off, int col_off, float rate, float inv_keep,
           uint32_t seed) {
  constexpr bool kLo = sizeof(T) == 4;
  constexpr int NT = D / 8;
  constexpr int NQ = BQ / 8;             // 8-column steps over a query tile
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * BK;
  const uint32_t thr = keep_threshold(rate);
  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2;
  const int t = lane & 3;
  const TileCtx tc{bh, wr, g, t, Lk, causal, row_off, col_off,
                   sm_scale, inv_keep, seed, thr};

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // [BK][D], swizzled
  T* sV = sK + BK * D;                     // [BK][D]
  T* sQ = sV + BK * D;                     // [2][BQ][D]
  T* sdO = sQ + 2 * BQ * D;                // [2][BQ][D]
  T* sO = sdO + 2 * BQ * D;                // [BQ][D] out of the next tile
  float* sL = reinterpret_cast<float*>(sO + BQ * D);  // [BQ] lse
  float* sD = sL + BQ;                                // [BQ] delta

  const long long qoff = b * sq_.b + h * sq_.h;
  const long long koff = b * sk_.b + h * sk_.h;

  // query tiles wholly above the diagonal see none of these keys
  int qt0 = 0;
  if (causal) qt0 = max(0, col_off + k0 - row_off) / BQ;
  const int n_qt = (Lq + BQ - 1) / BQ;

  const long long lrow = (long long)bh * Lq;
  float lse_next = INFINITY;             // lse of row threadIdx.x of the
  if (qt0 < n_qt) {                      // next tile (threads < BQ)
    cp_tile<BK, D, kThreads>(sK, k + koff, sk_.l, k0, Lk);
    cp_tile<BK, D, kThreads>(sV, v + koff, sk_.l, k0, Lk);
    const int q0 = qt0 * BQ;
    T* nQ = sQ + (qt0 & 1) * BQ * D;
    T* ndO = sdO + (qt0 & 1) * BQ * D;
    cp_tile<BQ, D, kThreads>(nQ, q + qoff, sq_.l, q0, Lq);
    cp_tile<BQ, D, kThreads>(ndO, dout + qoff, sq_.l, q0, Lq);
    cp_tile<BQ, D, kThreads>(sO, out + qoff, sq_.l, q0, Lq);
    cp_commit();
    if (threadIdx.x < BQ && q0 + threadIdx.x < Lq)
      lse_next = lse[lrow + q0 + threadIdx.x];
  }

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.0f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    const T* cQ = sQ + (qt & 1) * BQ * D;
    const T* cdO = sdO + (qt & 1) * BQ * D;
    // tile qt has landed; every warp is done with tile qt - 1's buffers,
    // lse and delta
    cp_wait_all();
    __syncthreads();
    if (threadIdx.x < BQ) sL[threadIdx.x] = lse_next;
    {
      const int r = threadIdx.x >> 1;
      const float d = row_delta<D>(sO, cdO, r, threadIdx.x & 1);
      if ((threadIdx.x & 1) == 0) sD[r] = d;
    }
    // lse and delta are visible and out is free: the next tile's copy
    // runs under this tile's products
    __syncthreads();
    if (qt + 1 < n_qt) {
      const int n0 = q0 + BQ;
      T* nQ = sQ + ((qt + 1) & 1) * BQ * D;
      T* ndO = sdO + ((qt + 1) & 1) * BQ * D;
      cp_tile<BQ, D, kThreads>(nQ, q + qoff, sq_.l, n0, Lq);
      cp_tile<BQ, D, kThreads>(ndO, dout + qoff, sq_.l, n0, Lq);
      cp_tile<BQ, D, kThreads>(sO, out + qoff, sq_.l, n0, Lq);
      cp_commit();
      lse_next = INFINITY;
      if (threadIdx.x < BQ && n0 + threadIdx.x < Lq)
        lse_next = lse[lrow + n0 + threadIdx.x];
    }

    // s^T = k.q^T and dp^T = v.do^T over the warp's 16 keys, 64 queries
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
    score_pair<D>(st, dpt, sK, sV, cQ, cdO, wr, g, t);
    dkv_step<D, T, kDrop>(st, dpt, dk_acc, dv_acc, cQ, cdO, sL, sD, q0, k0,
                          tc);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = k0 + wr + g + 8 * i;
    if (c >= Lk) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const long long at_ = koff + c * sk_.l + n * 8 + 2 * t;
      st2(dk + at_, dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
      st2(dv + at_, dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

// -- D = 64 * nc: chunked over the head width --------------------------------

template <typename T>
constexpr size_t dq_wide_smem() {       // 2 x (q, do, k, v) chunk tiles
  return sizeof(T) * (size_t)2 * (2 * BQ + 2 * BK) * 64;
}
template <typename T>
constexpr size_t dkv_wide_smem() {      // 2 x (k, v, q, do, out); lse, delta
  return sizeof(T) * (size_t)2 * (2 * BK + 3 * BQ) * 64 +
         2 * BQ * sizeof(float);
}

// one block per (query tile, batch*head, output chunk oc); a stage is one
// (key tile, input chunk)
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ out,
               const T* __restrict__ dout, const float* __restrict__ lse,
               T* __restrict__ dq, int H, int Lq, int Lk, Strides sq_,
               Strides sk_, float sm_scale, int causal, int row_off,
               int col_off, float rate, float inv_keep, uint32_t seed,
               int nc) {
  constexpr int D = 64;
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
  T* sdO = sQ + 2 * BQ * D;                // [2][BQ][64]
  T* sK = sdO + 2 * BQ * D;                // [2][BK][64]
  T* sV = sK + 2 * BK * D;                 // [2][BK][64]

  const long long qoff = b * sq_.b + h * sq_.h;
  const long long koff = b * sk_.b + h * sk_.h;
  const int n_tiles =
      (live_keys(q0, Lq, Lk, causal, row_off, col_off) + BK - 1) / BK;
  const int n_stages = n_tiles * nc;

  // delta of the warp's rows over all chunks of out and do, through the
  // first q and do buffers, before the key loop
  float dsum = 0.0f;
  for (int c = 0; c < nc; ++c) {
    cp_tile<BQ, D, kThreads>(sQ, out + qoff + c * D, sq_.l, q0, Lq);
    cp_tile<BQ, D, kThreads>(sdO, dout + qoff + c * D, sq_.l, q0, Lq);
    cp_commit();
    cp_wait_all();
    __syncthreads();
    dsum += row_delta<D>(sQ, sdO, wr + (lane >> 1), lane & 1);
    __syncthreads();
  }
  float lse_r[2], delta_r[2];
  delta_r[0] = __shfl_sync(0xffffffffu, dsum, 2 * g);
  delta_r[1] = __shfl_sync(0xffffffffu, dsum, 2 * g + 16);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + wr + g + 8 * i;
    lse_r[i] = r < Lq ? lse[(long long)bh * Lq + r] : INFINITY;
  }

  // stage st: key tile st / nc, chunk (oc + 1 + st % nc) % nc
  auto copy_stage = [&](int st) {
    const int kt = st / nc, i = st - kt * nc, buf = st & 1;
    const int c = (oc + 1 + i) % nc;
    cp_tile<BQ, D, kThreads>(sQ + buf * BQ * D, q + qoff + c * D, sq_.l, q0,
                             Lq);
    cp_tile<BQ, D, kThreads>(sdO + buf * BQ * D, dout + qoff + c * D, sq_.l,
                             q0, Lq);
    cp_tile<BK, D, kThreads>(sK + buf * BK * D, k + koff + c * D, sk_.l,
                             kt * BK, Lk);
    cp_tile<BK, D, kThreads>(sV + buf * BK * D, v + koff + c * D, sk_.l,
                             kt * BK, Lk);
    cp_commit();
  };
  if (n_stages > 0) copy_stage(0);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float s[NK][4], dp[NK][4];

  for (int st = 0; st < n_stages; ++st) {
    const int kt = st / nc, i = st - kt * nc, buf = st & 1;
    const int k0 = kt * BK;
    const T* cQ = sQ + buf * BQ * D;
    const T* cdO = sdO + buf * BQ * D;
    const T* cK = sK + buf * BK * D;
    const T* cV = sV + buf * BK * D;
    cp_wait_all();
    __syncthreads();
    if (st + 1 < n_stages) copy_stage(st + 1);

    if (i == 0) {
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    }
    score_pair<D>(s, dp, cQ, cdO, cK, cV, wr, g, t);
    if (i != nc - 1) continue;
    // chunk oc of k, which this last stage holds
    dq_step<D, T, kDrop>(s, dp, acc, cK, lse_r, delta_r, q0, k0, tc);
  }

  T* dqb = dq + qoff + oc * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + wr + g + 8 * i;
    if (r >= Lq) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      st2(dqb + r * sq_.l + n * 8 + 2 * t, acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// one block per (key tile, batch*head, output chunk oc); a stage is one
// (query tile, input chunk) and copies that chunk of k, v, q, do and out
template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads)
dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ out,
                const T* __restrict__ dout, const float* __restrict__ lse,
                T* __restrict__ dk, T* __restrict__ dv, int H, int Lq, int Lk,
                Strides sq_, Strides sk_, float sm_scale, int causal,
                int row_off, int col_off, float rate, float inv_keep,
                uint32_t seed, int nc) {
  constexpr int D = 64;
  constexpr bool kLo = sizeof(T) == 4;
  constexpr int NT = D / 8;
  constexpr int NQ = BQ / 8;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * BK;
  const int oc = blockIdx.z;
  const uint32_t thr = keep_threshold(rate);
  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2;
  const int t = lane & 3;
  const TileCtx tc{bh, wr, g, t, Lk, causal, row_off, col_off,
                   sm_scale, inv_keep, seed, thr};

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // [2][BK][64], swizzled
  T* sV = sK + 2 * BK * D;                 // [2][BK][64]
  T* sQ = sV + 2 * BK * D;                 // [2][BQ][64]
  T* sdO = sQ + 2 * BQ * D;                // [2][BQ][64]
  T* sO = sdO + 2 * BQ * D;                // [2][BQ][64]
  float* sL = reinterpret_cast<float*>(sO + 2 * BQ * D);  // [BQ] lse
  float* sD = sL + BQ;                                    // [BQ] delta

  const long long qoff = b * sq_.b + h * sq_.h;
  const long long koff = b * sk_.b + h * sk_.h;
  int qt0 = 0;
  if (causal) qt0 = max(0, col_off + k0 - row_off) / BQ;
  const int n_qt = (Lq + BQ - 1) / BQ;
  const int n_stages = max(0, n_qt - qt0) * nc;
  const long long lrow = (long long)bh * Lq;

  // stage st: query tile qt0 + st / nc, chunk (oc + 1 + st % nc) % nc
  auto copy_stage = [&](int st) {
    const int qi = st / nc, i = st - qi * nc, buf = st & 1;
    const int q0 = (qt0 + qi) * BQ;
    const int c = (oc + 1 + i) % nc;
    cp_tile<BK, D, kThreads>(sK + buf * BK * D, k + koff + c * D, sk_.l, k0,
                             Lk);
    cp_tile<BK, D, kThreads>(sV + buf * BK * D, v + koff + c * D, sk_.l, k0,
                             Lk);
    cp_tile<BQ, D, kThreads>(sQ + buf * BQ * D, q + qoff + c * D, sq_.l, q0,
                             Lq);
    cp_tile<BQ, D, kThreads>(sdO + buf * BQ * D, dout + qoff + c * D, sq_.l,
                             q0, Lq);
    cp_tile<BQ, D, kThreads>(sO + buf * BQ * D, out + qoff + c * D, sq_.l,
                             q0, Lq);
    cp_commit();
  };
  if (n_stages > 0) copy_stage(0);

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.0f;
  float st_[NQ][4], dpt[NQ][4];
  float dsum = 0.0f;          // delta of query row threadIdx.x / 2

  for (int st = 0; st < n_stages; ++st) {
    const int qi = st / nc, i = st - qi * nc, buf = st & 1;
    const int q0 = (qt0 + qi) * BQ;
    const T* cK = sK + buf * BK * D;
    const T* cV = sV + buf * BK * D;
    const T* cQ = sQ + buf * BQ * D;
    const T* cdO = sdO + buf * BQ * D;
    cp_wait_all();
    __syncthreads();
    if (st + 1 < n_stages) copy_stage(st + 1);

    if (i == 0) {
      dsum = 0.0f;
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st_[j][e] = dpt[j][e] = 0.0f;
    }
    dsum += row_delta<D>(sO + buf * BQ * D, cdO, threadIdx.x >> 1,
                         threadIdx.x & 1);
    score_pair<D>(st_, dpt, cK, cV, cQ, cdO, wr, g, t);
    if (i != nc - 1) continue;

    // the query tile's lse and delta, visible to every warp (the last
    // reads of the previous tile's came before this stage's barrier)
    if (threadIdx.x < BQ)
      sL[threadIdx.x] =
          q0 + (int)threadIdx.x < Lq ? lse[lrow + q0 + threadIdx.x]
                                     : INFINITY;
    if ((threadIdx.x & 1) == 0) sD[threadIdx.x >> 1] = dsum;
    __syncthreads();

    // chunk oc of do and q, which this last stage holds
    dkv_step<D, T, kDrop>(st_, dpt, dk_acc, dv_acc, cQ, cdO, sL, sD, q0, k0,
                          tc);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = k0 + wr + g + 8 * i;
    if (c >= Lk) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const long long at_ = koff + c * sk_.l + oc * D + n * 8 + 2 * t;
      st2(dk + at_, dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
      st2(dv + at_, dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  int B, H, Lq, Lk;
  Strides sq, sk;
  float sm_scale;
  int causal, row_off, col_off;
  float rate, inv_keep;
  uint32_t seed;
};

// dynamic shared memory past 48 KB, and the carveout that lets two
// blocks share an SM
template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int D, typename T, bool kDrop>
int launch_dq(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = dq_smem<T>(D);
  auto kernel = dq_kernel<D, T, kDrop>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Lq + BQ - 1) / BQ, a.B * a.H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.out),
      static_cast<const T*>(a.dout), a.lse, static_cast<T*>(a.dq), a.H,
      a.Lq, a.Lk, a.sq, a.sk, a.sm_scale, a.causal, a.row_off, a.col_off,
      a.rate, a.inv_keep, a.seed);
  return (int)cudaGetLastError();
}

template <int D, typename T, bool kDrop>
int launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = dkv_smem<T>(D);
  auto kernel = dkv_kernel<D, T, kDrop>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Lk + BK - 1) / BK, a.B * a.H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.out),
      static_cast<const T*>(a.dout), a.lse, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.H, a.Lq, a.Lk, a.sq, a.sk, a.sm_scale,
      a.causal, a.row_off, a.col_off, a.rate, a.inv_keep, a.seed);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch(bool dkv, const BwdArgs& a, cudaStream_t stream) {
  // dropout is a template parameter: no per-element branch on the rate
  if (a.rate > 0.0f)
    return dkv ? launch_dkv<D, T, true>(a, stream)
               : launch_dq<D, T, true>(a, stream);
  return dkv ? launch_dkv<D, T, false>(a, stream)
             : launch_dq<D, T, false>(a, stream);
}

template <typename T, bool kDrop>
int launch_dq_wide(int nc, const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = dq_wide_smem<T>();
  auto kernel = dq_wide_kernel<T, kDrop>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Lq + BQ - 1) / BQ, a.B * a.H, nc);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.out),
      static_cast<const T*>(a.dout), a.lse, static_cast<T*>(a.dq), a.H,
      a.Lq, a.Lk, a.sq, a.sk, a.sm_scale, a.causal, a.row_off, a.col_off,
      a.rate, a.inv_keep, a.seed, nc);
  return (int)cudaGetLastError();
}

template <typename T, bool kDrop>
int launch_dkv_wide(int nc, const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = dkv_wide_smem<T>();
  auto kernel = dkv_wide_kernel<T, kDrop>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Lk + BK - 1) / BK, a.B * a.H, nc);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.out),
      static_cast<const T*>(a.dout), a.lse, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.H, a.Lq, a.Lk, a.sq, a.sk, a.sm_scale,
      a.causal, a.row_off, a.col_off, a.rate, a.inv_keep, a.seed, nc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wide(bool dkv, int nc, const BwdArgs& a, cudaStream_t stream) {
  if (a.rate > 0.0f)
    return dkv ? launch_dkv_wide<T, true>(nc, a, stream)
               : launch_dq_wide<T, true>(nc, a, stream);
  return dkv ? launch_dkv_wide<T, false>(nc, a, stream)
             : launch_dq_wide<T, false>(nc, a, stream);
}

// the head widths of the repo's configurations and the reference's
// kernel tests, and any multiple of 64 above them (the wide kernels);
// the wrapper pads every other width up to the next of those
template <typename T>
int dispatch(bool dkv, int D, const BwdArgs& a, cudaStream_t stream) {
  switch (D) {
    case 8: return launch<8, T>(dkv, a, stream);
    case 16: return launch<16, T>(dkv, a, stream);
    case 32: return launch<32, T>(dkv, a, stream);
    case 64: return launch<64, T>(dkv, a, stream);
    default:
      if (D > 64 && D % 64 == 0)
        return launch_wide<T>(dkv, D / 64, a, stream);
      return (int)cudaErrorInvalidValue;
  }
}

int run(bool dkv, const void* q, const void* k, const void* v,
        const void* out, const void* dout, const float* lse, void* dq,
        void* dk, void* dv, int B, int H, int Lq, int Lk, int D,
        long long q_sb, long long q_sh, long long q_sl, long long k_sb,
        long long k_sh, long long k_sl, float sm_scale, int causal,
        int row_off, int col_off, float rate, float inv_keep,
        unsigned int seed, int dtype, void* stream) {
  const BwdArgs a{q,  k,     v,        out,    dout,    lse,
                  dq, dk,    dv,       B,      H,       Lq,
                  Lk, {q_sb, q_sh, q_sl}, {k_sb, k_sh, k_sl},
                  sm_scale, causal, row_off, col_off, rate, inv_keep, seed};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(dkv, D, a, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(dkv, D, a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace flash

extern "C" {

// dynamic shared memory of one block, in bytes, for fp32 inputs (bf16
// inputs take half the tile bytes); D > 64 uses 64-wide chunk tiles
size_t flash_attention_dq_smem_bytes(int D) {
  return D > 64 ? flash::dq_wide_smem<float>() : flash::dq_smem<float>(D);
}

size_t flash_attention_dkv_smem_bytes(int D) {
  return D > 64 ? flash::dkv_wide_smem<float>() : flash::dkv_smem<float>(D);
}

// dq of the bias-free flash attention.  dtype: 0 fp32, 1 bf16; strides
// in elements; dq has q's strides.  Every tensor's base must be 16-byte
// aligned and its rows (D elements) contiguous: tiles are copied in
// 16-byte pieces.  Returns the launch's CUDA error.
int flash_attention_dq(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const float* lse,
                       void* dq, int B, int H, int Lq, int Lk, int D,
                       long long q_sb, long long q_sh, long long q_sl,
                       long long k_sb, long long k_sh, long long k_sl,
                       float sm_scale, int causal, int row_off, int col_off,
                       float rate, float inv_keep, unsigned int seed,
                       int dtype, void* stream) {
  return flash::run(false, q, k, v, out, dout, lse, dq, nullptr, nullptr, B,
                    H, Lq, Lk, D, q_sb, q_sh, q_sl, k_sb, k_sh, k_sl,
                    sm_scale, causal, row_off, col_off, rate, inv_keep, seed,
                    dtype, stream);
}

// dk and dv of the bias-free flash attention; both have k's strides.
int flash_attention_dkv(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const float* lse,
                        void* dk, void* dv, int B, int H, int Lq, int Lk,
                        int D, long long q_sb, long long q_sh,
                        long long q_sl, long long k_sb, long long k_sh,
                        long long k_sl, float sm_scale, int causal,
                        int row_off, int col_off, float rate, float inv_keep,
                        unsigned int seed, int dtype, void* stream) {
  return flash::run(true, q, k, v, out, dout, lse, nullptr, dk, dv, B, H,
                    Lq, Lk, D, q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, sm_scale,
                    causal, row_off, col_off, rate, inv_keep, seed, dtype,
                    stream);
}

}  // extern "C"
