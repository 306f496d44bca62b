// Ragged paged attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ragged_kernel` of
// paddle_tpu/kernels/flash_attention.py (launched by `_ragged_pallas`,
// entry `ragged_decode_attention`).  It computes what that kernel and its
// plain version `_ragged_xla` compute:
//
//   q      [B, C, H, D] fp32  (C = 1 decode, C = chunk rows in prefill)
//   pool   [H, R, ps, D] fp32 | bf16 | int8, head-major: one head's page
//          is a contiguous ps x D slab
//   table  [B, P] int32 logical pages; physical K row of page p is
//          (p * n_layer + layer) * 2, the V row the one after it
//   lengths, q_base [B] int32;  scales [R, ps] fp32 (int8 pools only)
//   out    [B, C, H, D] fp32
//
// For each lane b and query row j, keys at global position col are kept
// when col < lengths[b] and, if causal, col <= q_base[b] + j.  A masked
// score is replaced by -1e9 exactly as the reference does; a row with no
// kept key (a dead lane, length 0) outputs 0.  int8 values dequantize
// with the per-(row, slot) scale, bf16 values upcast to fp32; all
// arithmetic is fp32.
//
// Bound: the bytes of the live pages it reads.  Each (lane, head) walks
// only the pages below its length, so a lane reads
// ceil(length / ps) * 2 * ps * D pool elements per head; q, out and the
// tables are small beside that.  At C = 32 with a bf16 or int8 pool the
// fp32 dot products come close to the card's fp32 rate as well.
//
// Design, first version (plain and right before fast):
//   * one block per (lane, head), 128 threads; the block reads its own
//     page-table row (the TPU kernel had it scalar-prefetched) and loops
//     over pages while p * ps < length, instead of the TPU's sequential
//     grid axis with running stats carried in VMEM scratch;
//   * a page's K and V slabs are loaded into shared memory with
//     neighbouring threads on neighbouring elements along D, so the
//     loads coalesce; dequantization happens on the way in;
//   * the running max m, sum l and a kept-key flag per query row, and
//     the [C, D] accumulator, live in shared memory;
//   * no tensor cores, TMA or split over pages yet: at decode (C = 1)
//     there are only B * H blocks, fewer than the card's SMs, and the
//     page loads are not overlapped with the arithmetic.  Those are the
//     levers a later version pulls to approach the byte bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kMasked = -1e9f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const float* __restrict__ q,
                              const T* __restrict__ pool,
                              const float* __restrict__ scales,
                              const int* __restrict__ table,
                              const int* __restrict__ lengths,
                              const int* __restrict__ q_base,
                              float* __restrict__ out, int C, int H, int R,
                              int ps, int D, int P, int layer, int n_layer,
                              int causal, float sm_scale) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* sq = smem;              // [C][D]   queries of this (lane, head)
  float* sk = sq + C * D;        // [ps][D]  K slab of the current page
  float* sv = sk + ps * D;       // [ps][D]  V slab
  float* ss = sv + ps * D;       // [C][ps]  scores, then probabilities
  float* sacc = ss + C * ps;     // [C][D]   unnormalised output
  float* sm = sacc + C * D;      // [C]      running max
  float* sl = sm + C;            // [C]      running sum
  float* salpha = sl + C;        // [C]      rescale factor of this page
  int* skept = reinterpret_cast<int*>(salpha + C);  // [C] any key kept

  const int length = lengths[b];
  const int base = q_base[b];
  for (int i = tid; i < C * D; i += kThreads) {
    const int c = i / D, d = i - c * D;
    sq[i] = q[((static_cast<size_t>(b) * C + c) * H + h) * D + d];
    sacc[i] = 0.f;
  }
  for (int c = tid; c < C; c += kThreads) {
    sm[c] = -INFINITY;
    sl[c] = 0.f;
    skept[c] = 0;
  }
  __syncthreads();

  const size_t slab = static_cast<size_t>(ps) * D;
  for (int p = 0; p < P && p * ps < length; ++p) {
    // clamp like XLA's gather, so a bad page id cannot read out of bounds
    long long krow =
        (static_cast<long long>(table[b * P + p]) * n_layer + layer) * 2;
    krow = krow < 0 ? 0 : (krow > R - 2 ? R - 2 : krow);
    const T* kp = pool + (static_cast<size_t>(h) * R + krow) * slab;
    const T* vp = kp + slab;
    for (int i = tid; i < ps * D; i += kThreads) {
      float kx = to_float(kp[i]);
      float vx = to_float(vp[i]);
      if (scales != nullptr) {
        const int s = i / D;
        kx *= scales[krow * ps + s];
        vx *= scales[(krow + 1) * ps + s];
      }
      sk[i] = kx;
      sv[i] = vx;
    }
    __syncthreads();

    const int p0 = p * ps;
    for (int i = tid; i < C * ps; i += kThreads) {
      const int c = i / ps, s = i - c * ps;
      const float* qr = sq + c * D;
      const float* kr = sk + s * D;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
      dot *= sm_scale;
      const int col = p0 + s;
      const bool keep = col < length && (!causal || col <= base + c);
      ss[i] = keep ? dot : kMasked;
      if (keep) skept[c] = 1;  // every writer stores the same value
    }
    __syncthreads();

    for (int c = tid; c < C; c += kThreads) {
      float* row = ss + c * ps;
      const float m_prev = sm[c];
      float m_cur = -INFINITY;
      for (int s = 0; s < ps; ++s) m_cur = fmaxf(m_cur, row[s]);
      const float m_new = fmaxf(m_prev, m_cur);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int s = 0; s < ps; ++s) {
        const float e = expf(row[s] - m_new);
        row[s] = e;
        sum += e;
      }
      sl[c] = alpha * sl[c] + sum;
      sm[c] = m_new;
      salpha[c] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < C * D; i += kThreads) {
      const int c = i / D, d = i - c * D;
      const float* pr = ss + c * ps;
      float a = sacc[i] * salpha[c];
      for (int s = 0; s < ps; ++s) a += pr[s] * sv[s * D + d];
      sacc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < C * D; i += kThreads) {
    const int c = i / D, d = i - c * D;
    out[((static_cast<size_t>(b) * C + c) * H + h) * D + d] =
        skept[c] ? sacc[i] / sl[c] : 0.f;
  }
}

template <typename T>
cudaError_t launch(const float* q, const void* pool, const float* scales,
                   const int* table, const int* lengths, const int* q_base,
                   float* out, int B, int C, int H, int R, int ps, int D,
                   int P, int layer, int n_layer, int causal, float sm_scale,
                   size_t smem_bytes, cudaStream_t stream) {
  auto kernel = ragged_paged_attention_kernel<T>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(B, H);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      q, static_cast<const T*>(pool), scales, table, lengths, q_base, out, C,
      H, R, ps, D, P, layer, n_layer, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (the wrapper checks it
// against the card's per-block limit before launching).
size_t ragged_paged_attention_smem_bytes(int C, int ps, int D) {
  return (static_cast<size_t>(2) * C * D + 2 * ps * D + C * ps + 4 * C) *
         sizeof(float);
}

// pool_dtype: 0 fp32, 1 bf16, 2 int8 (int8 needs scales).  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int ragged_paged_attention(const float* q, const void* pool,
                           const float* scales, const int* table,
                           const int* lengths, const int* q_base, float* out,
                           int B, int C, int H, int R, int ps, int D, int P,
                           int layer, int n_layer, int causal, float sm_scale,
                           int pool_dtype, void* stream) {
  const size_t smem = ragged_paged_attention_smem_bytes(C, ps, D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (pool_dtype) {
    case 0:
      err = launch<float>(q, pool, nullptr, table, lengths, q_base, out, B,
                          C, H, R, ps, D, P, layer, n_layer, causal,
                          sm_scale, smem, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(q, pool, nullptr, table, lengths, q_base,
                                  out, B, C, H, R, ps, D, P, layer, n_layer,
                                  causal, sm_scale, smem, s);
      break;
    case 2:
      if (scales == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      err = launch<int8_t>(q, pool, scales, table, lengths, q_base, out, B,
                           C, H, R, ps, D, P, layer, n_layer, causal,
                           sm_scale, smem, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
