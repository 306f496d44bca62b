// Fused LSTM forward time loop for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel `_cell_kernel` of tools/lstm_probe.py (launched
// by `pallas_lstm_fwd`), over the whole contract of the `dynamic_lstm` op
// (paddle_tpu/fluid/ops/rnn_ops.py:57):
//
//   x        [B, T, 4H] pre-projected input (the fc before the LSTM)
//   w        [H, 4H]    recurrence weight; gate blocks c~, i, f, o
//   bias     [4H] gate bias, then optional peepholes w_ic, w_fc, w_oc [H]
//   h0, c0   optional [B, H] initial state (else 0)
//   lengths  [B] int32; past a row's length the carry is frozen and the
//            outputs are 0.  is_reverse walks t = T-1 .. 0.
//   h, c     [B, T, H] outputs
//
// Each step:  a = (x_t + h @ w) + bias;  i = act_g(a_i + w_ic c),
// f = act_g(a_f + w_fc c), c' = f c + i act_cand(a_c~),
// o = act_g(a_o + w_oc c'), h' = o act_cell(c').  Codes: 0 sigmoid,
// 1 tanh, 2 relu, 3 identity (the order of rnn_ops._ACTS).
//
// Bound: fp32 operations.  The recurrent product is 2*B*T*H*4H flops
// (26.8 GFLOP at B=128, T=100, H=512: 0.40 ms at 67 TFLOP/s), against
// 0.29 ms for the 52 MB of x, w, h and c at 3.35 TB/s.  On the TPU the
// point of the kernel was keeping w and the carry on chip; on the card
// the point is also the launch count: an eager step is ~10 small kernels,
// so the loop in one launch replaces ~10*T launches.
//
// Design, first version (plain and right before fast):
//   * one launch runs the whole time loop.  Step t+1 needs all of h_t, so
//     the blocks meet at a grid-wide barrier (a monotone atomic counter)
//     after each step.  The launch is cooperative, which refuses a grid
//     whose blocks cannot all be resident; the host plan sizes the grid
//     to at most one block per SM and the wrapper raises if none fits;
//   * block (unit group, batch group) owns k hidden units across all four
//     gates for Bs batch rows, so the cell update is local: thread
//     (du, rg) owns unit du for rows rg + i*RG (i < R) and keeps their c
//     and h carry in registers for all T steps;
//   * h_{t-1} lives in a global double buffer [2, B, H] (step t reads one
//     half, writes the other, so no step races the next), read through
//     L2 (ld.cg) in chunks of 32 columns staged in shared memory;
//   * the block's [H, 4k] weight slice sits in shared memory for the
//     whole loop when it fits (k=4 at H=512, 32 KB; k=10 at H=1280,
//     205 KB), else it is read from L2 each step;
//   * products on the CUDA cores in fp32; no tensor cores, no overlap of
//     the h chunk loads with the products, one thread per (unit, row
//     group): those are what a later version uses.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace lstm {
namespace {

constexpr int kThreads = 256;
constexpr int kRowsMax = 8;          // batch rows one thread may own
constexpr int kChunk = 32;           // h columns staged per pass
constexpr int kPad = kChunk + 1;     // smem row pitch: conflict-free rows

struct Params {
  const float* x;
  const float* w;
  const float* bias;
  const float* peep;                 // w_ic, w_fc, w_oc or null
  const float* h0;                   // or null
  const float* c0;                   // or null
  const int* lengths;
  float* h_out;
  float* c_out;
  float* hbuf;                       // [2, B, H]
  unsigned int* counter;             // zeroed before the launch
  int B, T, H, k, Bs, nh, reverse, act_gate, act_cell, act_cand, w_smem;
};

__device__ __forceinline__ float act(int code, float v) {
  switch (code) {
    case 0: return 1.f / (1.f + expf(-v));
    case 1: return tanhf(v);
    case 2: return fmaxf(v, 0.f);
    default: return v;
  }
}

// all blocks arrive, then all leave: the counter only grows, so barrier n
// waits for n * gridDim.x arrivals.  The fence publishes this block's
// writes of the h buffer before its arrival is counted.
__device__ __forceinline__ void grid_barrier(unsigned int* counter,
                                             unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (*(volatile unsigned int*)counter < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1) lstm_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int H = p.H, k = p.k, T = p.T;
  const int RG = kThreads / k;                 // row groups
  const int ub = blockIdx.x % p.nh, bg = blockIdx.x / p.nh;
  const int u0 = ub * k, b0 = bg * p.Bs;
  const int kk = min(k, H - u0);               // units of this block
  const int bs = min(p.Bs, p.B - b0);          // rows of this block
  float* hs = smem;                            // [R * RG][kPad]
  float* ws = smem + R * RG * kPad;            // [H][4k] if w_smem

  const float* wb;                             // w(j, g, du) =
  int ldw, gs;                                 //   wb[j*ldw + g*gs + du]
  if (p.w_smem) {
    for (int idx = threadIdx.x; idx < H * 4 * k; idx += kThreads) {
      const int j = idx / (4 * k), r = idx - j * 4 * k;
      const int g = r / k, du = r - g * k;
      ws[idx] = du < kk ? p.w[(size_t)j * 4 * H + g * H + u0 + du] : 0.f;
    }
    wb = ws; ldw = 4 * k; gs = k;
  } else {
    wb = p.w + u0; ldw = 4 * H; gs = H;
  }

  const int du = threadIdx.x % k, rg = threadIdx.x / k;
  const bool mine = rg < RG && rg < bs && du < kk;
  const int u = u0 + du;
  float bc = 0.f, bi = 0.f, bf = 0.f, bo = 0.f;
  float wic = 0.f, wfc = 0.f, woc = 0.f;
  float hc[R], cc[R];
  int len[R];
  if (mine) {
    bc = p.bias[u]; bi = p.bias[H + u]; bf = p.bias[2 * H + u];
    bo = p.bias[3 * H + u];
    if (p.peep) {
      wic = p.peep[u]; wfc = p.peep[H + u]; woc = p.peep[2 * H + u];
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int bb = rg + i * RG;
    hc[i] = cc[i] = 0.f;
    len[i] = 0;
    if (mine && bb < bs) {
      const int b = b0 + bb;
      if (p.h0) hc[i] = p.h0[(size_t)b * H + u];
      if (p.c0) cc[i] = p.c0[(size_t)b * H + u];
      len[i] = p.lengths[b];
      __stcg(p.hbuf + (size_t)b * H + u, hc[i]);
    }
  }
  grid_barrier(p.counter, gridDim.x);

  const size_t BH = (size_t)p.B * H;
  for (int s = 0; s < T; ++s) {
    const int t = p.reverse ? T - 1 - s : s;
    const float* cur = p.hbuf + (s & 1) * BH;
    float* nxt = p.hbuf + ((s + 1) & 1) * BH;
    float acc[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

    for (int j0 = 0; j0 < H; j0 += kChunk) {
      const int jn = min(kChunk, H - j0);
      __syncthreads();
      for (int idx = threadIdx.x; idx < R * RG * kChunk; idx += kThreads) {
        const int bb = idx / kChunk, jj = idx - bb * kChunk;
        hs[bb * kPad + jj] = (bb < bs && jj < jn)
            ? __ldcg(cur + (size_t)(b0 + bb) * H + j0 + jj) : 0.f;
      }
      __syncthreads();
      if (mine) {
        const float* wr = wb + (size_t)j0 * ldw + du;
        const float* hr = hs + rg * kPad;
        for (int jj = 0; jj < jn; ++jj) {
          const float w0 = wr[0], w1 = wr[gs], w2 = wr[2 * gs],
                      w3 = wr[3 * gs];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float hv = hr[i * RG * kPad + jj];
            acc[i][0] = fmaf(hv, w0, acc[i][0]);
            acc[i][1] = fmaf(hv, w1, acc[i][1]);
            acc[i][2] = fmaf(hv, w2, acc[i][2]);
            acc[i][3] = fmaf(hv, w3, acc[i][3]);
          }
          wr += ldw;
        }
      }
    }

    if (mine) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int bb = rg + i * RG;
        if (bb >= bs) continue;
        const int b = b0 + bb;
        const float* xr = p.x + ((size_t)b * T + t) * 4 * H + u;
        const float gc = (xr[0] + acc[i][0]) + bc;
        float gi = (xr[H] + acc[i][1]) + bi;
        float gf = (xr[2 * H] + acc[i][2]) + bf;
        float go = (xr[3 * H] + acc[i][3]) + bo;
        const float cp = cc[i];
        gi += wic * cp;
        gf += wfc * cp;
        const float ig = act(p.act_gate, gi), fg = act(p.act_gate, gf);
        const float cn = fg * cp + ig * act(p.act_cand, gc);
        go += woc * cn;
        const float hn = act(p.act_gate, go) * act(p.act_cell, cn);
        const bool valid = t < len[i];
        const size_t o = ((size_t)b * T + t) * H + u;
        p.h_out[o] = valid ? hn : 0.f;
        p.c_out[o] = valid ? cn : 0.f;
        if (valid) { hc[i] = hn; cc[i] = cn; }
        __stcg(nxt + (size_t)b * H + u, hc[i]);
      }
    }
    if (s + 1 < T) grid_barrier(p.counter, (unsigned int)(s + 2) * gridDim.x);
  }
}

// the work split: plan[0..6] = k, nb, Bs, R, grid, smem bytes, w_smem
struct Plan {
  int k, nb, Bs, R, grid, smem, w_smem;
};

int make_plan(int B, int H, int sms, int smem_max, Plan* out) {
  bool found = false;
  Plan best{};
  long long best_cost = 0;
  for (int k = 1; k <= H && k <= kThreads; ++k) {
    const int nh = (H + k - 1) / k;
    if (nh > sms) continue;
    int nb = sms / nh;
    nb = nb < 1 ? 1 : (nb > B ? B : nb);
    const int Bs = (B + nb - 1) / nb;
    nb = (B + Bs - 1) / Bs;
    const int RG = kThreads / k;
    const int R = (Bs + RG - 1) / RG;
    if (R > kRowsMax) continue;
    const long long hs = (long long)R * RG * kPad * sizeof(float);
    const long long wsz = (long long)H * 4 * k * sizeof(float);
    const int w_smem = hs + wsz <= smem_max;
    const long long smem = hs + (w_smem ? wsz : 0);
    if (smem > smem_max) continue;
    // w in shared memory first (read from L2 it costs 4H^2 floats a
    // step), then the fewest (row, unit) pairs per block, then the
    // smaller grid
    const long long cost = (w_smem ? 0 : (1LL << 40)) + (long long)Bs * k;
    if (!found || cost < best_cost ||
        (cost == best_cost && nh * nb < best.grid)) {
      found = true;
      best_cost = cost;
      best = Plan{k, nb, Bs, R, nh * nb, (int)smem, w_smem};
    }
  }
  if (!found) return (int)cudaErrorInvalidConfiguration;
  *out = best;
  return 0;
}

template <int R>
int launch(const Params& p, const Plan& pl, cudaStream_t st) {
  const void* fn = (const void*)lstm_fwd_kernel<R>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                    pl.smem);
  if (e != cudaSuccess) return (int)e;
  if ((long long)per_sm * sms < pl.grid)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  Params q = p;
  void* args[] = {&q};
  e = cudaLaunchCooperativeKernel(fn, dim3(pl.grid), dim3(kThreads), args,
                                  (size_t)pl.smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace lstm

extern "C" {

// The work split the launch would use for B rows and H units on the
// current device: plan[0..6] = k, nb, Bs, R, grid, smem bytes, w in
// shared memory.  Returns 0, or a CUDA error code when no split fits.
int lstm_fwd_plan(int B, int H, int* plan) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  lstm::Plan pl;
  const int err = lstm::make_plan(B, H, sms, smem_max, &pl);
  if (err) return err;
  const int v[7] = {pl.k, pl.nb, pl.Bs, pl.R, pl.grid, pl.smem, pl.w_smem};
  for (int i = 0; i < 7; ++i) plan[i] = v[i];
  return 0;
}

// Pointers as described at the top; peep, h0 and c0 may be null.  hbuf
// is [2, B, H] scratch and counter one zeroed uint32.  Returns the CUDA
// error of the launch (0 on success).
int lstm_fwd(const float* x, const float* w, const float* bias,
             const float* peep, const float* h0, const float* c0,
             const int* lengths, float* h_out, float* c_out, float* hbuf,
             unsigned int* counter, int B, int T, int H, int reverse,
             int act_gate, int act_cell, int act_cand, void* stream) {
  int v[7];
  int err = lstm_fwd_plan(B, H, v);
  if (err) return err;
  const lstm::Plan pl{v[0], v[1], v[2], v[3], v[4], v[5], v[6]};
  const lstm::Params p{x, w, bias, peep, h0, c0, lengths, h_out, c_out,
                       hbuf, counter, B, T, H, pl.k, pl.Bs,
                       (H + pl.k - 1) / pl.k, reverse, act_gate, act_cell,
                       act_cand, pl.w_smem};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pl.R) {
    case 1: return lstm::launch<1>(p, pl, st);
    case 2: return lstm::launch<2>(p, pl, st);
    case 3: return lstm::launch<3>(p, pl, st);
    case 4: return lstm::launch<4>(p, pl, st);
    case 5: return lstm::launch<5>(p, pl, st);
    case 6: return lstm::launch<6>(p, pl, st);
    case 7: return lstm::launch<7>(p, pl, st);
    case 8: return lstm::launch<8>(p, pl, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
