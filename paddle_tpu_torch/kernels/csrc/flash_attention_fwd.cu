// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of
// paddle_tpu/kernels/flash_attention.py (launched by `_pallas_forward`,
// entry `flash_attention`).  It computes what that kernel and its plain
// version `_xla_forward` compute:
//
//   q [B, Lq, H, D] ('blhd', the Transformer's layout) or [B, H, Lq, D]
//   ('bhld'); k, v likewise with Lk; fp32 or bf16, D = 64
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
// +inf, so the backward's exp(s - lse) is 0 there.
//
// Bound: fp32 operations.  At the training path's shapes (B=64, L=256,
// H=8, D=64) one call does 4*B*H*L^2*D = 8.6 GFLOP (half of it under the
// causal mask), 0.128 ms at the card's 67 TFLOP/s of fp32, against
// 0.040 ms for the 134 MB that q, k, v and out move at 3.35 TB/s.
//
// Design, first version (plain and right before fast):
//   * one block per (query tile of 64 rows, batch*head), 256 threads; the
//     TPU's serial key-block grid axis, which carried m, l and the
//     accumulator in VMEM scratch, is a loop inside the block, and the
//     three stay in registers (4 rows x D/16 columns per thread);
//   * q, k and v are read in place through their strides, so 'blhd'
//     needs no transpose; the TPU's [block, 128] lane-broadcast stat
//     tiles become one lse float per row;
//   * tiles are staged in shared memory as fp32 (bf16 converts on load)
//     and the products run on the CUDA cores in fp32; key tiles wholly
//     above the causal diagonal are skipped, and lengths that are not a
//     multiple of 64 are handled by bounds checks, not padding;
//   * no tensor cores, TMA, or overlap of loads with arithmetic yet: those
//     are what a later version uses to approach the operation bound.

#include "flash_attention_common.cuh"

namespace flash {
namespace {

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ bias,
           T* __restrict__ out, float* __restrict__ lse, int H, int Lq,
           int Lk, Strides sq_, Strides sk_, int bias_b, int bias_h,
           float sm_scale, int causal, int row_off, int col_off,
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
  float* sK = sQ + BQ * P;     // [BK][D + 1]
  float* sV = sK + BK * P;     // [BK][D + 1]
  float* sP = sV + BK * P;     // [BQ][BK + 1]  dropped p of this tile

  const T* qb = q + b * sq_.b + h * sq_.h;
  const T* kb = k + b * sk_.b + h * sk_.h;
  const T* vb = v + b * sk_.b + h * sk_.h;
  const float* biasb =
      bias == nullptr
          ? nullptr
          : bias + ((long long)(bias_b > 1 ? b : 0) * bias_h +
                    (bias_h > 1 ? h : 0)) * (long long)Lq * Lk;

  load_tile<BQ, D>(sQ, qb, sq_.l, q0, Lq);

  // keys past the last live column of this tile's last row never count
  int n_keys = Lk;
  if (causal) {
    const int last_row = row_off + min(q0 + BQ, Lq) - 1;
    n_keys = max(0, min(Lk, last_row - col_off + 1));
  }
  const int n_tiles = (n_keys + BK - 1) / BK;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's sK, sV, sP are consumed
    load_tile<BK, D>(sK, kb, sk_.l, k0, Lk);
    load_tile<BK, D>(sV, vb, sk_.l, k0, Lk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * P + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * P + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        float x = s[i][j] * sm_scale;
        if (biasb != nullptr && r < Lq && c < Lk)
          x += biasb[(long long)r * Lk + c];
        if (!kept(r, c, Lk, causal, row_off, col_off)) x = kMask;
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
      }
      row_max = half_warp_max(row_max);
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        float pd = p;
        if (rate > 0.0f)
          pd *= keep_scale(seed, bh, row_off + r, col_off + k0 + tx + 16 * j,
                           rate, inv_keep);
        sP[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = pd;
      }
      l[i] = alpha * l[i] + half_warp_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = sV[kk * P + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(ty * 4 + i) * (BK + 1) + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

  T* ob = out + b * sq_.b + h * sq_.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Lq) continue;
    const bool dead = l[i] == 0.0f || m[i] <= kMask * 0.5f;
    const float denom = dead ? 1.0f : l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store(ob + r * sq_.l + tx + 16 * c, dead ? 0.0f : acc[i][c] / denom);
    if (tx == 0)
      lse[(long long)bh * Lq + r] = dead ? INFINITY : m[i] + logf(denom);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* out, float* lse, int B, int H, int Lq, int Lk, Strides sq_,
           Strides sk_, int bias_b, int bias_h, float sm_scale, int causal,
           int row_off, int col_off, float rate, float inv_keep,
           uint32_t seed, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(D);
  auto kernel = fwd_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), lse, H, Lq, Lk,
      sq_, sk_, bias_b, bias_h, sm_scale, causal, row_off, col_off, rate,
      inv_keep, seed);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v,
             const float* bias, void* out, float* lse, int B, int H, int Lq,
             int Lk, Strides sq_, Strides sk_, int bias_b, int bias_h,
             float sm_scale, int causal, int row_off, int col_off,
             float rate, float inv_keep, uint32_t seed,
             cudaStream_t stream) {
  // the one head width a configuration uses (d_key = d_value = 64)
  if (D != 64) return (int)cudaErrorInvalidValue;
  return launch<64, T>(q, k, v, bias, out, lse, B, H, Lq, Lk, sq_, sk_,
                       bias_b, bias_h, sm_scale, causal, row_off, col_off,
                       rate, inv_keep, seed, stream);
}

}  // namespace
}  // namespace flash

extern "C" {

// dynamic shared memory of one forward block: q, k and v tiles plus the
// tile of dropped probabilities
size_t flash_attention_fwd_smem_bytes(int D) {
  return flash::fwd_smem_bytes(D);
}

// dtype: 0 fp32, 1 bf16.  bias may be null; bias_b / bias_h are its
// leading extents (1 or B, 1 or H).  Strides are in elements.  Returns
// the CUDA error of the launch (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const float* bias, void* out, float* lse, int B,
                        int H, int Lq, int Lk, int D, long long q_sb,
                        long long q_sh, long long q_sl, long long k_sb,
                        long long k_sh, long long k_sl, int bias_b,
                        int bias_h, float sm_scale, int causal, int row_off,
                        int col_off, float rate, float inv_keep,
                        unsigned int seed, int dtype, void* stream) {
  const flash::Strides sq_{q_sb, q_sh, q_sl};
  const flash::Strides sk_{k_sb, k_sh, k_sl};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return flash::dispatch<float>(D, q, k, v, bias, out, lse, B, H, Lq, Lk,
                                  sq_, sk_, bias_b, bias_h, sm_scale, causal,
                                  row_off, col_off, rate, inv_keep, seed, st);
  if (dtype == 1)
    return flash::dispatch<__nv_bfloat16>(
        D, q, k, v, bias, out, lse, B, H, Lq, Lk, sq_, sk_, bias_b, bias_h,
        sm_scale, causal, row_off, col_off, rate, inv_keep, seed, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
