// Flash-attention backward for Hopper (sm_90a): two kernels, dq and
// dk/dv.
//
// `dq_kernel` replaces the TPU kernel `_dq_kernel` and `dkv_kernel` the
// TPU kernel `_dkv_kernel` of paddle_tpu/kernels/flash_attention.py (both
// launched by `_pallas_backward`, entry `flash_attention`).  They compute
// what those kernels and the plain `_xla_backward` compute, bias-free:
//
//   q, k, v, out, dout  as in the forward ('blhd' or 'bhld', fp32 or bf16)
//   lse [B, H, Lq] fp32, +inf on dead rows
//   dq like q, dk and dv like k, in the input dtype
//
// p is recomputed from the saved lse, p = exp(s - lse), under the same
// masks as the forward; delta = rowsum(out * dout) is formed in the
// kernel from the (dropped) output.  With dropout, dp is multiplied by
// the forward's keep_scale; dv takes p * keep and dk takes
// ds = p * (dp * keep - delta) * sm_scale.  With a bias the backward is
// the plain one, as the reference routes it (it has no bias-carrying
// backward kernel and dbias needs the [Lq, Lk] shape anyway).
//
// Bound: fp32 operations.  At B=64, L=256, H=8, D=64, dq recomputes s
// and dp and forms dq, 6*B*H*L^2*D = 12.9 GFLOP (0.19 ms at 67 TFLOP/s);
// dk/dv forms s, dp, dv and dk, 8*B*H*L^2*D = 17.2 GFLOP (0.26 ms); half
// of each under the causal mask.  The bytes (q, k, v, out, dout, lse
// read once, the gradients written once) take under 0.07 ms at 3.35 TB/s.
//
// Design, first version (plain and right before fast):
//   * dq: one block per (query tile, batch*head) looping over key tiles;
//     dk/dv: one block per (key tile, batch*head) looping over query
//     tiles -- the TPU's serial grid axes become these loops, and the
//     accumulators sit in registers instead of VMEM scratch;
//   * tensors are read in place through their strides, tiles staged in
//     shared memory as fp32, products on the CUDA cores in fp32; the
//     lse is one float per row, not a [block, 128] lane-broadcast tile;
//   * tiles wholly above the causal diagonal are skipped; ragged lengths
//     are bounds checks (rows past Lq get lse = +inf, so p = 0);
//   * no tensor cores, TMA or load/compute overlap yet.

#include "flash_attention_common.cuh"

namespace flash {
namespace {

// rowsum(out * dout) of this thread's four query rows: the half-warp
// splits the D columns and reduces with shuffles
template <int D, typename T>
__device__ __forceinline__ void row_delta(float delta[4], const T* ob,
                                          const float* sdO,
                                          long long row_stride, int q0,
                                          int Lq, int ty, int tx) {
  constexpr int NC = D / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lr = ty * 4 + i;
    const int r = q0 + lr;
    float acc = 0.0f;
    if (r < Lq) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        acc += to_float(ob[r * row_stride + d]) * sdO[lr * (D + 1) + d];
      }
    }
    delta[i] = half_warp_sum(acc);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ out,
          const T* __restrict__ dout, const float* __restrict__ lse,
          T* __restrict__ dq, int H, int Lq, int Lk, Strides sq_,
          Strides sk_, float sm_scale, int causal, int row_off, int col_off,
          float rate, float inv_keep, uint32_t seed) {
  constexpr int NC = D / 16;
  constexpr int P = D + 1;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  extern __shared__ float smem[];
  float* sQ = smem;            // [BQ][D + 1]
  float* sdO = sQ + BQ * P;    // [BQ][D + 1]
  float* sK = sdO + BQ * P;    // [BK][D + 1]
  float* sV = sK + BK * P;     // [BK][D + 1]
  float* sS = sV + BK * P;     // [BQ][BK + 1]  ds of this tile

  const long long qoff = b * sq_.b + h * sq_.h;
  const long long koff = b * sk_.b + h * sk_.h;
  load_tile<BQ, D>(sQ, q + qoff, sq_.l, q0, Lq);
  load_tile<BQ, D>(sdO, dout + qoff, sq_.l, q0, Lq);
  __syncthreads();

  float delta[4], lse_r[4];
  row_delta<D>(delta, out + qoff, sdO, sq_.l, q0, Lq, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    lse_r[i] = r < Lq ? lse[(long long)bh * Lq + r] : INFINITY;
  }

  int n_keys = Lk;
  if (causal) {
    const int last_row = row_off + min(q0 + BQ, Lq) - 1;
    n_keys = max(0, min(Lk, last_row - col_off + 1));
  }
  const int n_tiles = (n_keys + BK - 1) / BK;

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<BK, D>(sK, k + koff, sk_.l, k0, Lk);
    load_tile<BK, D>(sV, v + koff, sk_.l, k0, Lk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty * 4 + i) * P + d];
        ov[i] = sdO[(ty * 4 + i) * P + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(tx + 16 * j) * P + d];
        vv[j] = sV[(tx + 16 * j) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        float x = s[i][j] * sm_scale;
        if (!kept(r, c, Lk, causal, row_off, col_off)) x = kMask;
        const float p = expf(x - lse_r[i]);
        float g = dp[i][j];
        if (rate > 0.0f)
          g *= keep_scale(seed, bh, row_off + r, col_off + c, rate,
                          inv_keep);
        sS[(ty * 4 + i) * (BK + 1) + tx + 16 * j] =
            p * (g - delta[i]) * sm_scale;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = sK[kk * P + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = sS[(ty * 4 + i) * (BK + 1) + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }

  T* dqb = dq + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Lq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store(dqb + r * sq_.l + tx + 16 * c, acc[i][c]);
  }
}

// thread (ty, tx) owns key rows ty*4 + i of the tile and query columns
// tx + 16*j of the transposed score tile s^T [BK][BQ]
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ out,
           const T* __restrict__ dout, const float* __restrict__ lse,
           T* __restrict__ dk, T* __restrict__ dv, int H, int Lq, int Lk,
           Strides sq_, Strides sk_, float sm_scale, int causal,
           int row_off, int col_off, float rate, float inv_keep,
           uint32_t seed) {
  constexpr int NC = D / 16;
  constexpr int P = D + 1;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * BK;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  extern __shared__ float smem[];
  float* sK = smem;                // [BK][D + 1]
  float* sV = sK + BK * P;         // [BK][D + 1]
  float* sQ = sV + BK * P;         // [BQ][D + 1]
  float* sdO = sQ + BQ * P;        // [BQ][D + 1]
  float* sPk = sdO + BQ * P;       // [BK][BQ + 1]  p * keep, transposed
  float* sS = sPk + BK * (BQ + 1); // [BK][BQ + 1]  ds, transposed
  float* sL = sS + BK * (BQ + 1);  // [BQ] lse of the query tile
  float* sD = sL + BQ;             // [BQ] delta of the query tile

  const long long qoff = b * sq_.b + h * sq_.h;
  const long long koff = b * sk_.b + h * sk_.h;
  load_tile<BK, D>(sK, k + koff, sk_.l, k0, Lk);
  load_tile<BK, D>(sV, v + koff, sk_.l, k0, Lk);

  // query tiles wholly above the diagonal see none of these keys
  int qt0 = 0;
  if (causal) qt0 = max(0, col_off + k0 - row_off) / BQ;
  const int n_qt = (Lq + BQ - 1) / BQ;

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile<BQ, D>(sQ, q + qoff, sq_.l, q0, Lq);
    load_tile<BQ, D>(sdO, dout + qoff, sq_.l, q0, Lq);
    __syncthreads();
    {
      // lse and delta of the query tile: each half-warp takes 4 rows
      float delta[4];
      row_delta<D>(delta, out + qoff, sdO, sq_.l, q0, Lq, ty, tx);
      if (tx == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = q0 + ty * 4 + i;
          sD[ty * 4 + i] = delta[i];
          sL[ty * 4 + i] = r < Lq ? lse[(long long)bh * Lq + r] : INFINITY;
        }
      }
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = sK[(ty * 4 + i) * P + d];
        vv[i] = sV[(ty * 4 + i) * P + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = sQ[(tx + 16 * j) * P + d];
        ov[j] = sdO[(tx + 16 * j) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = k0 + ty * 4 + i;           // key position
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int lq = tx + 16 * j;
        const int r = q0 + lq;                 // query position
        float x = s[i][j] * sm_scale;
        if (!kept(r, c, Lk, causal, row_off, col_off)) x = kMask;
        const float p = expf(x - sL[lq]);
        float keep = 1.0f;
        if (rate > 0.0f)
          keep = keep_scale(seed, bh, row_off + r, col_off + c, rate,
                            inv_keep);
        sPk[(ty * 4 + i) * (BQ + 1) + lq] = p * keep;
        sS[(ty * 4 + i) * (BQ + 1) + lq] =
            p * (dp[i][j] * keep - sD[lq]) * sm_scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float ov[NC], qv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        ov[c] = sdO[qq * P + tx + 16 * c];
        qv[c] = sQ[qq * P + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pk = sPk[(ty * 4 + i) * (BQ + 1) + qq];
        const float ds = sS[(ty * 4 + i) * (BQ + 1) + qq];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv_acc[i][c] = fmaf(pk, ov[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(ds, qv[c], dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty * 4 + i;
    if (c >= Lk) continue;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const long long at = koff + c * sk_.l + tx + 16 * cc;
      store(dk + at, dk_acc[i][cc]);
      store(dv + at, dv_acc[i][cc]);
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

template <int D, typename T>
int launch_dq(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes(D);
  auto kernel = dq_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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

template <int D, typename T>
int launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes(D);
  auto kernel = dkv_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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

template <typename T>
int dispatch(bool dkv, int D, const BwdArgs& a, cudaStream_t stream) {
  // the one head width a configuration uses (d_key = d_value = 64)
  if (D != 64) return (int)cudaErrorInvalidValue;
  return dkv ? launch_dkv<64, T>(a, stream) : launch_dq<64, T>(a, stream);
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

size_t flash_attention_dq_smem_bytes(int D) {
  return flash::dq_smem_bytes(D);
}

size_t flash_attention_dkv_smem_bytes(int D) {
  return flash::dkv_smem_bytes(D);
}

// dq of the bias-free flash attention.  dtype: 0 fp32, 1 bf16; strides
// in elements; dq has q's strides.  Returns the launch's CUDA error.
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
