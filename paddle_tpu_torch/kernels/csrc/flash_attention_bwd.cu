// Flash-attention backward for Hopper (sm_90a): two kernels, dq and
// dk/dv, in two designs: 3xTF32 mma.sync (fp32 at every width, bf16 at
// D = 8 and above 64; this note's first part) and, for bf16 at D = 64,
// the Transformer's d_key, warpgroup products on TMA-fed tiles
// (`dq_wg_kernel`, `dkv_wg_kernel`; the second part, below).
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
//     bf16 tensor is exact in TF32, so its correction product is skipped;
//     for bf16 inputs ds and p * keep are rounded to bf16 before their
//     products, as the reference rounds them (and as the D = 64 bf16
//     kernels below do), so they too are exact in TF32.
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
//
// bf16 at D = 64: `dq_wg_kernel` and `dkv_wg_kernel` replace the same
// TPU kernels and round as they do: ds (after sm_scale) to bf16 before
// ds.k and ds^T.q, and the dropped p to bf16 before p^T.do
// (flash_attention.py:777, 827, 831), with fp32 sums.  dq first: it
// forms delta = rowsum(out * dout) once per query tile and writes it to
// a float32 [B, H, Lq] buffer; dk/dv reads it there, so it never reads
// out.
//
// Bound, at the training shape in bf16: the bytes.  dq reads q, k, v,
// out, dout and lse and writes dq and delta (101 MB, 0.030 ms at 3.35
// TB/s); dk/dv reads q, k, v, dout, lse and delta and writes dk and dv
// (101 MB, 0.030 ms).  Their products, 12.9 and 17.2 GFLOP on the full
// calls, take 0.013 and 0.017 ms at the bf16 tensor-core rate (989
// TFLOP/s); with dropout the hash's 8 int32 ALU operations a live score
// take ~0.016 ms a full call.
//
// Design (the forward's `fwd_wg_kernel` turned around):
//   * one warpgroup (128 threads) a block; dq: 64 query rows and a loop
//     over 64-key tiles, grid (query tiles, B*H), the last query tiles
//     first (under the causal mask they see the most keys); dk/dv: 64
//     key rows and a loop over 64-query tiles, grid (key tiles, B*H);
//   * all five products are wgmma.m64n64k16, bf16 in, fp32 out, four
//     16-deep steps each: s, dp (dq) and s^T, dp^T (dk/dv) read both
//     operands K-major from shared memory; dq += ds.k, dv += (p*keep).do
//     and dk += ds.q take their A operand from registers (ds and p*keep
//     rounded to bf16 out of the score accumulators, the repack of
//     flash_attention_mma.cuh's p_frag) and their B operand MN-major
//     (k, do and q: the depth runs down the tile's rows; wgmma reads
//     16-bit types either way through its transpose bit);
//   * tiles come by TMA into the 128-byte swizzle wgmma reads: dq's q
//     and do, dk/dv's k and v once; the streamed tiles (k, v; q, do)
//     through a ring of kBwdStages slots with an mbarrier each, one tile
//     in flight while one is in use; dk/dv's lse and delta for a query
//     tile go into shared memory beside its slot, a tile ahead, by the
//     threads;
//   * p = 2^(s * scale * log2 e - lse * log2 e): one fused multiply-add
//     and an exp a score; the mask only on the tiles that need it (the
//     causal diagonal, a ragged Lk); tiles wholly above the diagonal are
//     skipped; rows past L read as zeros and carry lse = +inf, so p = 0;
//   * dq, dk and dv accumulate in the wgmma accumulators across the
//     loop: fresh per-tile partials (flash_attention_fwd.cu's kPart,
//     which a chain of mma.sync products needed) measured no more
//     accurate here, at L = 256 and 4096, and 3-4% slower;
//   * two passes and no atomics, so the gradients are the same from run
//     to run; the outputs go out through shared memory in 16-byte
//     pieces, rows past L never written.
// Shared memory a block: six 8 KB tiles (two once-loaded, two ring slots
// of two), lse and delta of the ring's tiles, the barriers: 51,224
// bytes.  Blocks an SM, measured fastest at the training shape
// (tune_flash_bwd.py): dq 4 (at most 128 registers: ptxas gives it 128,
// no spills), dk/dv 3 (at most 168: a few bytes of spills, still 10%
// faster than two blocks at 207 registers).

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
// q0 + wr + g + 8 * (e / 2), key column k0 + 8j + 2t + e % 2), rounded
// to bf16 for bf16 inputs as the reference rounds it
// (flash_attention.py:777), then acc += ds.k, k-step j being keys
// 8j..8j+7; cK is the tile's k (a 64-column chunk of it in the wide
// kernel)
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
      const float ds = p * (gd - delta_r[e >> 1]) * c.sm_scale;
      s[j][e] = kLo ? ds : rn_bf16(ds);
    }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    FragA ads;
    c_to_a<kLo>(ads, s[j]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      FragB bk;
      load_b_cols<D, kLo>(bk, cK, j * 8 + 2 * t, n * 8 + g);
      mma3<kLo, kLo>(acc[n], ads, bk);
    }
  }
}

// dk/dv's step for one query tile at q0: p * keep in place of s^T and ds
// in place of dp^T (key row k0 + wr + g + 8 * (e / 2), query column
// 8j + 2t + e % 2, whose lse and delta are sL and sD), both rounded to
// bf16 for bf16 inputs as the reference rounds them
// (flash_attention.py:827, 831), then
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
      const float ds = p * (dpt[j][e] * keep - sD[lq]) * c.sm_scale;
      st[j][e] = kLo ? p * keep : rn_bf16(p * keep);
      dpt[j][e] = kLo ? ds : rn_bf16(ds);
    }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    FragA ap, ads;
    c_to_a<kLo>(ap, st[j]);
    c_to_a<kLo>(ads, dpt[j]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      FragB bo, bq;
      load_b_cols<D, kLo>(bo, cdO, j * 8 + 2 * t, n * 8 + g);
      load_b_cols<D, kLo>(bq, cQ, j * 8 + 2 * t, n * 8 + g);
      mma3<kLo, kLo>(dv_acc[n], ap, bo);
      mma3<kLo, kLo>(dk_acc[n], ads, bq);
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
           const uint32_t* __restrict__ seed_p) {
  // the seed is read where it lies: a captured launch sees its value
  // at every replay
  const uint32_t seed = kDrop ? *seed_p : 0u;
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
               int col_off, float rate, float inv_keep,
               const uint32_t* __restrict__ seed_p,
               int nc) {
  // the seed is read where it lies: a captured launch sees its value
  // at every replay
  const uint32_t seed = kDrop ? *seed_p : 0u;
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
                const uint32_t* __restrict__ seed_p, int nc) {
  // the seed is read where it lies: a captured launch sees its value
  // at every replay
  const uint32_t seed = kDrop ? *seed_p : 0u;
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

// -- the bf16 kernels at D = 64: warpgroup products, TMA copies --------------
//
// dq_wg_kernel: one warpgroup (4 warps) a block and 64 query rows, a loop
// over 64-key tiles.  s = q.k^T and dp = do.v^T are four wgmma.m64n64k16
// each, both operands K-major in shared memory; p = 2^(s * scale * log2 e
// - lse * log2 e) on the accumulators (the mask only on tiles that need
// it), dp * keep, ds = p * (dp * keep - delta) * sm_scale, rounded to bf16
// into register A fragments (as the reference's _dq_kernel rounds
// ds.astype(k.dtype)); dq += ds.k four more, k read MN-major (the depth
// runs over the tile's keys).  q and do come once by TMA, k and v stream
// through a ring of kBwdStages slots.  delta = rowsum(out * dout) is
// formed once from memory before the loop and written to a [B, H, Lq]
// buffer for the dk/dv kernel.
//
// dkv_wg_kernel: the same for 64 key rows and a loop over query tiles:
// s^T = k.q^T and dp^T = v.do^T from shared memory; p * keep and ds,
// each rounded to bf16 as _dkv_kernel rounds them, into A fragments; dv
// += (p * keep).do and dk += ds.q with do and q read MN-major.  k and v
// come once by TMA; q and do stream through the ring, and the query
// tile's lse and delta (from the dq kernel's buffer) through shared
// memory beside them, loaded a tile ahead by the threads.
//
// Both: dq, dk and dv sum in the wgmma accumulators over the whole loop
// (no fresh partials: measured as accurate, and faster; PERF.md);
// the outputs are staged through shared memory, rounded to bf16, and
// written in 16-byte pieces, rows past L never; rows past L read as
// zeros (TMA) and carry lse = +inf, so p = 0 there.
constexpr int kBwdStages = 2;            // ring slots of the streamed tiles
constexpr int kDqBlocks = 4;             // blocks an SM (__launch_bounds__)
constexpr int kDkvBlocks = 3;
constexpr int kBwdThreads = 128;
constexpr int kBwdTile = 64 * 64;        // elements of a 64-row tile
constexpr uint32_t kBwdTileBytes = kBwdTile * sizeof(__nv_bfloat16);

constexpr size_t bwd_wg_smem() {  // 2 once-loaded tiles, the ring, lse,
  return (size_t)(2 + 2 * kBwdStages) * kBwdTileBytes   // delta, barriers
         + 2 * kBwdStages * 64 * sizeof(float) + 8 * (kBwdStages + 1) + 1024;
}

// the tensor maps of a call: q-shaped (q, do) and k-shaped (k, v)
struct BwdMaps {
  CUtensorMap q, dout, k, v;
};

__device__ __forceinline__ __nv_bfloat16* align1024(unsigned char* p) {
  return reinterpret_cast<__nv_bfloat16*>(((uintptr_t)p + 1023) &
                                          ~(uintptr_t)1023);
}

// rows r0.. of head (b, h) in a map of either order (wg_map)
__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int b, int h,
                                          int r0, int blhd) {
  if (blhd)
    tma_load(dst, map, bar, 0, h, r0, b);
  else
    tma_load(dst, map, bar, 0, r0, h, b);
}

// sum of the products of two rows of 8 bf16 values
__device__ __forceinline__ float dot8(const uint4& x, const uint4& y) {
  const uint32_t* a = reinterpret_cast<const uint32_t*>(&x);
  const uint32_t* c = reinterpret_cast<const uint32_t*>(&y);
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(a + i));
    const float2 w = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(c + i));
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}

// an accumulator rounded to bf16 into the swizzled 64 x 64 tile s (the
// layout TMA gave q), then written to rows r0.. of one head, 16 bytes a
// thread, rows at or past L never.  The caller has synchronised the
// block after its last read of s
__device__ __forceinline__ void store_tile(__nv_bfloat16* s,
                                           const float (&acc)[8][4],
                                           __nv_bfloat16* dst,
                                           long long row_stride, int r0,
                                           int L, int wr, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr + g + 8 * i;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      st2(s + r * 64 + ((n ^ (r & 7)) << 3) + 2 * t, acc[n][2 * i],
          acc[n][2 * i + 1]);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kBwdTile / 8 / kBwdThreads; ++i) {
    const int idx = threadIdx.x + i * kBwdThreads;
    const int r = idx >> 3, c = idx & 7;
    if (r0 + r < L)
      *reinterpret_cast<uint4*>(dst + (r0 + r) * row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(s + r * 64 + ((c ^ (r & 7)) << 3));
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
}

// dq's step on one key tile at k0: s (the warp's 16 query rows x 64 keys
// of q.k^T, as C fragments) and dp become ds, rounded to bf16 into the A
// fragments of the tile's four 16-key steps.  lse2 holds the thread's
// rows' lse in log2 units, rterm their hash row terms
template <bool kDrop, bool kMasked>
__device__ __forceinline__ void dq_ds(const float (&s)[8][4],
                                      const float (&dp)[8][4],
                                      uint32_t (&dsa)[4][4],
                                      const float (&lse2)[2],
                                      const float (&delta)[2],
                                      const uint32_t (&rterm)[2],
                                      uint32_t key, int q0, int k0,
                                      float scale2, const TileCtx& c) {
  const uint32_t cterm = (uint32_t)(c.col_off + k0 + 2 * c.t) * kColMul;
  float ds[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float x = fmaf(s[j][e], scale2, -lse2[i]);
      if (kMasked)
        x = live(q0 + c.wr + c.g + 8 * i, k0 + j * 8 + 2 * c.t + (e & 1),
                 c.Lk, c.causal, c.row_off, c.col_off) ? x : -INFINITY;
      const float p = ex2(x);
      float d = dp[j][e];
      if (kDrop) {
        const uint32_t pos =
            rterm[i] + cterm + (uint32_t)(j * 8 + (e & 1)) * kColMul;
        d = kept(pos, key, c.thr) ? d * c.inv_keep : 0.0f;
      }
      ds[j][e] = p * (d - delta[i]) * c.sm_scale;
    }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) p_frag(dsa[kk], ds, kk);
}

template <bool kDrop>
__global__ void __launch_bounds__(kBwdThreads, kDqBlocks)
dq_wg_kernel(const __grid_constant__ BwdMaps maps, int q_blhd, int kv_blhd,
             const __nv_bfloat16* __restrict__ out,
             const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int H, int Lq, int Lk,
             Strides sq_, float sm_scale, int causal, int row_off,
             int col_off, float rate, float inv_keep,
             const uint32_t* __restrict__ seed_p) {
  // the seed is read where it lies: a captured launch sees its value
  // at every replay
  const uint32_t seed = kDrop ? *seed_p : 0u;
  using T = __nv_bfloat16;
  constexpr int NS = kBwdStages;
  constexpr uint32_t kTileDesc = kBwdTileBytes >> 4;  // desc units
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  // the later query tiles see more keys under the causal mask: they run
  // first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 64;
  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's first row
  const int g = lane >> 2;
  const int t = lane & 3;
  const TileCtx tc{bh, wr, g, t, Lk, causal, row_off, col_off,
                   sm_scale, inv_keep, seed, keep_threshold(rate)};

  extern __shared__ unsigned char smem_raw[];
  T* sQ = align1024(smem_raw);           // [64][64]
  T* sdO = sQ + kBwdTile;                // [64][64]
  T* sK = sdO + kBwdTile;                // [NS][64][64]
  T* sV = sK + NS * kBwdTile;            // [NS][64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + NS * kBwdTile);  // [NS]
  uint64_t* qbar = full + NS;

  const int n_tiles =
      (live_keys(q0, Lq, Lk, causal, row_off, col_off) + 63) / 64;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st <= NS; ++st) mbar_init(full + st);
    mbar_init_fence();
    if (n_tiles > 0) {
      mbar_expect(qbar, 2 * kBwdTileBytes);
      load_rows(sQ, &maps.q, qbar, b, h, q0, q_blhd);
      load_rows(sdO, &maps.dout, qbar, b, h, q0, q_blhd);
    }
#pragma unroll
    for (int st = 0; st < NS - 1; ++st)
      if (st < n_tiles) {
        mbar_expect(full + st, 2 * kBwdTileBytes);
        load_rows(sK + st * kBwdTile, &maps.k, full + st, b, h, st * 64,
                  kv_blhd);
        load_rows(sV + st * kBwdTile, &maps.v, full + st, b, h, st * 64,
                  kv_blhd);
      }
  }

  // delta = rowsum(out * dout) of row wr + lane / 2, half a row a lane,
  // from memory while the copies run; then the rows g, g + 8 of the
  // thread's fragments
  const long long qoff = b * sq_.b + h * sq_.h;
  float dsum = 0.0f;
  const int dr = q0 + wr + (lane >> 1);
  if (dr < Lq) {
    const long long o = qoff + (long long)dr * sq_.l + (lane & 1) * 32;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      dsum += dot8(*reinterpret_cast<const uint4*>(out + o + 8 * c),
                   *reinterpret_cast<const uint4*>(dout + o + 8 * c));
  }
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  if ((lane & 1) == 0 && dr < Lq) delta[(long long)bh * Lq + dr] = dsum;
  const float delta_r[2] = {__shfl_sync(0xffffffffu, dsum, 2 * g),
                            __shfl_sync(0xffffffffu, dsum, 2 * g + 16)};
  float lse2[2];
  uint32_t rterm[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + wr + g + 8 * i;
    lse2[i] = r < Lq ? lse[(long long)bh * Lq + r] * kLog2e : INFINITY;
    rterm[i] = (uint32_t)(row_off + r) * kRowMul;
  }
  const uint32_t key = ((uint32_t)bh * kBhMul) ^ seed;
  const float scale2 = sm_scale * kLog2e;

  __syncthreads();                       // the barriers are initialised
  const uint64_t dQ = sw128_desc(sQ), ddO = sw128_desc(sdO);
  const uint64_t dK0 = sw128_desc(sK), dV0 = sw128_desc(sV);
  float acc[8][4];
  zero(acc);
  if (n_tiles > 0) mbar_wait(qbar, 0);

  const int row_lo = row_off + q0 + wr;  // the warp's first global row
  int slot = 0;                          // tile kt's ring slot
  uint32_t parity = 0;                   // and its barrier's phase
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * 64;
    // every warp is done with tile kt - 1, whose slot takes tile kt +
    // NS - 1
    if (kt > 0) __syncthreads();
    const int nt = kt + NS - 1;
    if (threadIdx.x == 0 && nt < n_tiles) {
      const int ns = slot == 0 ? NS - 1 : slot - 1;
      mbar_expect(full + ns, 2 * kBwdTileBytes);
      load_rows(sK + ns * kBwdTile, &maps.k, full + ns, b, h, nt * 64,
                kv_blhd);
      load_rows(sV + ns * kBwdTile, &maps.v, full + ns, b, h, nt * 64,
                kv_blhd);
    }
    mbar_wait(full + slot, parity);      // tile kt has landed
    const uint32_t off = slot * kTileDesc;
    if (++slot == NS) {
      slot = 0;
      parity ^= 1;
    }

    float s[8][4], dp[8][4];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss(s, desc_at(dQ, 32 * ks), desc_at(dK0 + off, 32 * ks), ks);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss(dp, desc_at(ddO, 32 * ks), desc_at(dV0 + off, 32 * ks), ks);
    wg_commit();
    wg_wait_all();
    keep_regs(s);
    keep_regs(dp);

    // the mask only where it can drop a key: past Lk, or causal keys
    // past the warp's first row
    uint32_t dsa[4][4];
    if (k0 + 64 > Lk || (causal && row_lo < col_off + k0 + 63))
      dq_ds<kDrop, true>(s, dp, dsa, lse2, delta_r, rterm, key, q0, k0,
                         scale2, tc);
    else
      dq_ds<kDrop, false>(s, dp, dsa, lse2, delta_r, rterm, key, q0, k0,
                          scale2, tc);

    // dq += ds.k: k-step kk is keys 16kk..16kk+15, rows of the k tile
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_mn(acc, dsa[kk], desc_at(dK0 + off, 2048 * kk), 1);
    wg_commit();
    wg_wait_all();
    keep_regs(acc);
  }

  __syncthreads();                       // every warp is done with q
  store_tile(sQ, acc, dq + qoff, sq_.l, q0, Lq, wr, g, t);
}

// dk/dv's step on one query tile at q0: s^T (the warp's 16 key rows x 64
// queries of k.q^T) and dp^T become p * keep and ds, each rounded to
// bf16 into the A fragments of the tile's four 16-query steps.  sL and
// sD hold the tile's lse (log2 units) and delta by query; kterm the hash
// column terms of the thread's two keys
template <bool kDrop, bool kMasked>
__device__ __forceinline__ void dkv_ds(const float (&st)[8][4],
                                       const float (&dpt)[8][4],
                                       uint32_t (&pa)[4][4],
                                       uint32_t (&dsa)[4][4],
                                       const float* sL, const float* sD,
                                       const uint32_t (&kterm)[2],
                                       uint32_t key, int q0, int k0,
                                       float scale2, const TileCtx& c) {
  const uint32_t qterm = (uint32_t)(c.row_off + q0 + 2 * c.t) * kRowMul;
  float pk[8][4], ds[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int lq = j * 8 + 2 * c.t;      // the pair's first query
    const float2 l2 = *reinterpret_cast<const float2*>(sL + lq);
    const float2 dl = *reinterpret_cast<const float2*>(sD + lq);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float x = fmaf(st[j][e], scale2, -((e & 1) ? l2.y : l2.x));
      if (kMasked)
        x = live(q0 + lq + (e & 1), k0 + c.wr + c.g + 8 * i, c.Lk,
                 c.causal, c.row_off, c.col_off) ? x : -INFINITY;
      const float p = ex2(x);
      float keep = 1.0f;
      if (kDrop) {
        const uint32_t pos =
            qterm + (uint32_t)(j * 8 + (e & 1)) * kRowMul + kterm[i];
        keep = kept(pos, key, c.thr) ? c.inv_keep : 0.0f;
      }
      pk[j][e] = p * keep;
      ds[j][e] = p * (dpt[j][e] * keep - ((e & 1) ? dl.y : dl.x)) *
                 c.sm_scale;
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    p_frag(pa[kk], pk, kk);
    p_frag(dsa[kk], ds, kk);
  }
}

template <bool kDrop>
__global__ void __launch_bounds__(kBwdThreads, kDkvBlocks)
dkv_wg_kernel(const __grid_constant__ BwdMaps maps, int q_blhd, int kv_blhd,
              const float* __restrict__ lse,
              const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
              __nv_bfloat16* __restrict__ dv, int H, int Lq, int Lk,
              Strides sk_, float sm_scale, int causal, int row_off,
              int col_off, float rate, float inv_keep,
              const uint32_t* __restrict__ seed_p) {
  // the seed is read where it lies: a captured launch sees its value
  // at every replay
  const uint32_t seed = kDrop ? *seed_p : 0u;
  using T = __nv_bfloat16;
  constexpr int NS = kBwdStages;
  constexpr uint32_t kTileDesc = kBwdTileBytes >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  // under the causal mask the first key tiles see the most queries, and
  // run first
  const int k0 = blockIdx.x * 64;
  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's first key row
  const int g = lane >> 2;
  const int t = lane & 3;
  const TileCtx tc{bh, wr, g, t, Lk, causal, row_off, col_off,
                   sm_scale, inv_keep, seed, keep_threshold(rate)};

  extern __shared__ unsigned char smem_raw[];
  T* sK = align1024(smem_raw);           // [64][64]
  T* sV = sK + kBwdTile;                 // [64][64]
  T* sQ = sV + kBwdTile;                 // [NS][64][64]
  T* sdO = sQ + NS * kBwdTile;           // [NS][64][64]
  float* sL = reinterpret_cast<float*>(sdO + NS * kBwdTile);  // [NS][64]
  float* sD = sL + NS * 64;                                   // [NS][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(sD + NS * 64);  // [NS]
  uint64_t* kvbar = full + NS;

  // query tiles wholly above the diagonal see none of these keys
  const int qt0 = causal ? max(0, col_off + k0 - row_off) / 64 : 0;
  const int n = max(0, (Lq + 63) / 64 - qt0);  // query tiles to visit
  // the lse (log2 units) and delta of query tile i into ring slot st, by
  // the threads: 0-63 lse, 64-127 delta
  const long long lrow = (long long)bh * Lq;
  auto stage_rows = [&](int i, int st) {
    const int r = (qt0 + i) * 64 + (threadIdx.x & 63);
    if (threadIdx.x < 64)
      sL[st * 64 + threadIdx.x] = r < Lq ? lse[lrow + r] * kLog2e : INFINITY;
    else
      sD[st * 64 + threadIdx.x - 64] = r < Lq ? delta[lrow + r] : 0.0f;
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st <= NS; ++st) mbar_init(full + st);
    mbar_init_fence();
    if (n > 0) {
      mbar_expect(kvbar, 2 * kBwdTileBytes);
      load_rows(sK, &maps.k, kvbar, b, h, k0, kv_blhd);
      load_rows(sV, &maps.v, kvbar, b, h, k0, kv_blhd);
    }
#pragma unroll
    for (int st = 0; st < NS - 1; ++st)
      if (st < n) {
        mbar_expect(full + st, 2 * kBwdTileBytes);
        load_rows(sQ + st * kBwdTile, &maps.q, full + st, b, h,
                  (qt0 + st) * 64, q_blhd);
        load_rows(sdO + st * kBwdTile, &maps.dout, full + st, b, h,
                  (qt0 + st) * 64, q_blhd);
      }
  }
#pragma unroll
  for (int st = 0; st < NS - 1; ++st)
    if (st < n) stage_rows(st, st);
  uint32_t kterm[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    kterm[i] = (uint32_t)(col_off + k0 + wr + g + 8 * i) * kColMul;
  const uint32_t key = ((uint32_t)bh * kBhMul) ^ seed;
  const float scale2 = sm_scale * kLog2e;

  __syncthreads();               // the barriers, lse and delta are ready
  const uint64_t dK = sw128_desc(sK), dV = sw128_desc(sV);
  const uint64_t dQ0 = sw128_desc(sQ), ddO0 = sw128_desc(sdO);
  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);
  if (n > 0) mbar_wait(kvbar, 0);

  const int key_hi = col_off + k0 + wr + 15;  // the warp's last key
  int slot = 0;
  uint32_t parity = 0;
  for (int i = 0; i < n; ++i) {
    const int q0 = (qt0 + i) * 64;
    // every warp is done with tile i - 1 (its q, do, lse and delta),
    // whose slot takes tile i + NS - 1
    if (i > 0) __syncthreads();
    const int ni = i + NS - 1;
    if (ni < n) {
      const int ns = slot == 0 ? NS - 1 : slot - 1;
      if (threadIdx.x == 0) {
        mbar_expect(full + ns, 2 * kBwdTileBytes);
        load_rows(sQ + ns * kBwdTile, &maps.q, full + ns, b, h,
                  (qt0 + ni) * 64, q_blhd);
        load_rows(sdO + ns * kBwdTile, &maps.dout, full + ns, b, h,
                  (qt0 + ni) * 64, q_blhd);
      }
      stage_rows(ni, ns);
    }
    mbar_wait(full + slot, parity);      // tile i has landed
    const int cur = slot;
    const uint32_t off = slot * kTileDesc;
    if (++slot == NS) {
      slot = 0;
      parity ^= 1;
    }

    float st[8][4], dpt[8][4];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss(st, desc_at(dK, 32 * ks), desc_at(dQ0 + off, 32 * ks), ks);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss(dpt, desc_at(dV, 32 * ks), desc_at(ddO0 + off, 32 * ks), ks);
    wg_commit();
    wg_wait_all();
    keep_regs(st);
    keep_regs(dpt);

    // the mask only where it can drop a pair: keys past Lk, or causal
    // queries before the warp's last key
    uint32_t pa[4][4], dsa[4][4];
    if (k0 + 64 > Lk || (causal && row_off + q0 < key_hi))
      dkv_ds<kDrop, true>(st, dpt, pa, dsa, sL + cur * 64, sD + cur * 64,
                          kterm, key, q0, k0, scale2, tc);
    else
      dkv_ds<kDrop, false>(st, dpt, pa, dsa, sL + cur * 64, sD + cur * 64,
                           kterm, key, q0, k0, scale2, tc);

    // dv += (p * keep).do and dk += ds.q: k-step kk is queries 16kk..,
    // rows of the do and q tiles
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_mn(dv_acc, pa[kk], desc_at(ddO0 + off, 2048 * kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_mn(dk_acc, dsa[kk], desc_at(dQ0 + off, 2048 * kk), 1);
    wg_commit();
    wg_wait_all();
    keep_regs(dv_acc);
    keep_regs(dk_acc);
  }

  __syncthreads();                       // every warp is done with k, v
  const long long koff = b * sk_.b + h * sk_.h;
  store_tile(sK, dk_acc, dk + koff, sk_.l, k0, Lk, wr, g, t);
  store_tile(sV, dv_acc, dv + koff, sk_.l, k0, Lk, wr, g, t);
}

struct BwdArgs {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, H, Lq, Lk;
  Strides sq, sk;
  float sm_scale;
  int causal, row_off, col_off;
  float rate, inv_keep;
  const uint32_t* seed;
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

template <bool kDrop>
int launch_wg(bool dkv, const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = bwd_wg_smem();
  const void* kernel = dkv ? (const void*)dkv_wg_kernel<kDrop>
                           : (const void*)dq_wg_kernel<kDrop>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const bool q_blhd = a.sq.h <= a.sq.l, kv_blhd = a.sk.h <= a.sk.l;
  BwdMaps maps;
  if (!a.delta || !wg_map(&maps.q, a.q, a.B, a.H, a.Lq, a.sq, q_blhd) ||
      !wg_map(&maps.dout, a.dout, a.B, a.H, a.Lq, a.sq, q_blhd) ||
      !wg_map(&maps.k, a.k, a.B, a.H, a.Lk, a.sk, kv_blhd) ||
      !wg_map(&maps.v, a.v, a.B, a.H, a.Lk, a.sk, kv_blhd))
    return (int)cudaErrorInvalidValue;
  using T = __nv_bfloat16;
  if (dkv) {
    dim3 grid((a.Lk + 63) / 64, a.B * a.H);
    dkv_wg_kernel<kDrop><<<grid, kBwdThreads, smem, stream>>>(
        maps, (int)q_blhd, (int)kv_blhd, a.lse, a.delta,
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.Lq, a.Lk, a.sk,
        a.sm_scale, a.causal, a.row_off, a.col_off, a.rate, a.inv_keep,
        a.seed);
  } else {
    dim3 grid((a.Lq + 63) / 64, a.B * a.H);
    dq_wg_kernel<kDrop><<<grid, kBwdThreads, smem, stream>>>(
        maps, (int)q_blhd, (int)kv_blhd, static_cast<const T*>(a.out),
        static_cast<const T*>(a.dout), a.lse, a.delta,
        static_cast<T*>(a.dq), a.H, a.Lq, a.Lk, a.sq, a.sm_scale, a.causal,
        a.row_off, a.col_off, a.rate, a.inv_keep, a.seed);
  }
  return (int)cudaGetLastError();
}

// the head widths of the repo's configurations and the reference's
// kernel tests, and any multiple of 64 above them (the wide kernels);
// the wrapper pads every other width up to the next of those.  bf16 at
// D = 64 runs the warpgroup kernels, every other (dtype, width) the
// 3xTF32 ones
template <typename T>
int dispatch(bool dkv, int D, const BwdArgs& a, cudaStream_t stream) {
  switch (D) {
    case 8: return launch<8, T>(dkv, a, stream);
    case 16: return launch<16, T>(dkv, a, stream);
    case 32: return launch<32, T>(dkv, a, stream);
    case 64:
      if constexpr (sizeof(T) == 2)
        return a.rate > 0.0f ? launch_wg<true>(dkv, a, stream)
                             : launch_wg<false>(dkv, a, stream);
      else return launch<64, T>(dkv, a, stream);
    default:
      if (D > 64 && D % 64 == 0)
        return launch_wide<T>(dkv, D / 64, a, stream);
      return (int)cudaErrorInvalidValue;
  }
}

int run(bool dkv, const void* q, const void* k, const void* v,
        const void* out, const void* dout, const float* lse, float* delta,
        void* dq, void* dk, void* dv, int B, int H, int Lq, int Lk, int D,
        long long q_sb, long long q_sh, long long q_sl, long long k_sb,
        long long k_sh, long long k_sl, float sm_scale, int causal,
        int row_off, int col_off, float rate, float inv_keep,
        const unsigned int* seed, int dtype, void* stream) {
  const BwdArgs a{q,  k,     v,        out,    dout,    lse,  delta,
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
// inputs take half the tile bytes, the bf16 D = 64 kernels less than the
// fp32 ones); D > 64 uses 64-wide chunk tiles
size_t flash_attention_dq_smem_bytes(int D) {
  return D > 64 ? flash::dq_wide_smem<float>() : flash::dq_smem<float>(D);
}

size_t flash_attention_dkv_smem_bytes(int D) {
  return D > 64 ? flash::dkv_wide_smem<float>() : flash::dkv_smem<float>(D);
}

// dq of the bias-free flash attention.  dtype: 0 fp32, 1 bf16; strides
// in elements; dq has q's strides.  seed points at the uint32 dropout
// seed on the card, read when rate > 0 (null otherwise).  delta is fp32 [B, H, Lq]: the bf16
// D = 64 kernel writes rowsum(out * dout) there for the dk/dv kernel,
// the others leave it as it is.  Every tensor's base must be 16-byte
// aligned and its rows (D elements) contiguous: tiles are copied in
// 16-byte pieces.  Returns the launch's CUDA error (cudaErrorInvalidValue
// for a null delta at bf16 D = 64, or a tensor map the driver refuses).
int flash_attention_dq(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const float* lse,
                       float* delta, void* dq, int B, int H, int Lq, int Lk,
                       int D, long long q_sb, long long q_sh, long long q_sl,
                       long long k_sb, long long k_sh, long long k_sl,
                       float sm_scale, int causal, int row_off, int col_off,
                       float rate, float inv_keep, const unsigned int* seed,
                       int dtype, void* stream) {
  return flash::run(false, q, k, v, out, dout, lse, delta, dq, nullptr,
                    nullptr, B, H, Lq, Lk, D, q_sb, q_sh, q_sl, k_sb, k_sh,
                    k_sl, sm_scale, causal, row_off, col_off, rate, inv_keep,
                    seed, dtype, stream);
}

// dk and dv of the bias-free flash attention; both have k's strides.  At
// bf16 D = 64 the kernel reads delta as a dq launch on the same inputs
// wrote it (it forms no delta of its own); the others ignore it.
int flash_attention_dkv(const void* q, const void* k, const void* v,
                        const void* out, const void* dout, const float* lse,
                        float* delta, void* dk, void* dv, int B, int H,
                        int Lq, int Lk, int D, long long q_sb,
                        long long q_sh, long long q_sl, long long k_sb,
                        long long k_sh, long long k_sl, float sm_scale,
                        int causal, int row_off, int col_off, float rate,
                        float inv_keep, const unsigned int* seed, int dtype,
                        void* stream) {
  return flash::run(true, q, k, v, out, dout, lse, delta, nullptr, dk, dv,
                    B, H, Lq, Lk, D, q_sb, q_sh, q_sl, k_sb, k_sh, k_sl,
                    sm_scale, causal, row_off, col_off, rate, inv_keep, seed,
                    dtype, stream);
}

}  // extern "C"
