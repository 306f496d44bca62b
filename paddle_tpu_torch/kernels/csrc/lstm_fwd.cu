// Fused LSTM forward time loop for Hopper (sm_90a), fp32 results.
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
// Bound.  The recurrent product is 2*B*T*H*4H operations (26.8 GFLOP at
// B=128, T=100, H=512); the forward moves x (105 MB there), w, the bias,
// h and c (26 MB each): about 161 MB, 0.048 ms at 3.35 TB/s.  So it is
// bound by operations: 0.40 ms at the 67 TFLOP/s of fp32 on the CUDA
// cores, or 0.16 ms for the three TF32 products below at 495 TFLOP/s
// (1.02 ms at H=1280).  Two things keep it far from that: mma.sync runs
// TF32 at a fraction of the card's TF32 rate (only wgmma reaches it), and
// step t+1 needs all of h_t, so each step pays a group-wide wait and an
// L2 round trip.
//
// Design:
//   * one cooperative launch runs all T steps, at most one block per SM
//     (the planner sizes the grid; the launch refuses a grid that cannot
//     be co-resident).  Block (unit group, batch group) owns k hidden units
//     across all four gates for Bs batch rows, so the cell update is local
//     and c stays in registers for all T steps;
//   * products on the tensor cores with fp32-level accuracy (3xTF32):
//     each operand is split into a TF32 high part and a TF32 low part
//     (round, one subtraction), and the product is hi*hi + hi*lo + lo*hi
//     in fp32 accumulators (mma.sync m16n8k8), each term in its own
//     accumulator.  One-pass TF32 is never used: over 100 steps it misses
//     the op's fp32 tolerance (tests/test_torch_lstm.py shows it);
//   * fragments come from shared memory by ldmatrix, two k-steps in turn
//     so one's loads are in flight while the other's products run;
//   * the weight slice sits in shared memory for the whole loop, n-major
//     (row n = slice column n = du*4 + gate, k contiguous), so an 8-column
//     n-tile is 2 units x 4 gates.  After the product, lane pairs swap
//     half their accumulators (one shuffle each way) and each lane holds
//     all four gates of one (row, unit): the cell update needs no shared
//     memory and no barrier.  Where no slice fits (H above 1320 at B=128)
//     the fragments are read from L2 instead: slow, and right;
//   * h_{t-1} lives in a global double buffer [2, B, hp] and is staged
//     with cp.async (16 bytes a thread, L2 only) into a ring of chunks of
//     kc columns, rows unpadded and XOR-swizzled: up to all of h in flight
//     at once, so the L2 round trip is paid about once a step, and the
//     product of chunk j runs while later chunks land.  Blocks start on
//     different chunks, so they do not all ask the same L2 lines at once;
//   * x_t is loaded into registers at the top of the step, before the
//     wait, so its latency is off the serial path; h and c of the step are
//     stored after the step's arrival, so the release waits for the h
//     buffer alone;
//   * the step barrier is per batch group: only blocks that share batch
//     rows wait for each other (red.release / ld.acquire on one counter
//     per group).
//
// Shared memory at B=128 on an H100 (232,448 bytes a block), from the
// planner in kernels/lstm.py (lstm_plan):
//   H=256:  k=16, 8 batch groups of 16 rows; w 66,560 B + 5 slots of 64
//           columns (the whole h tile in flight) = 87,040 B;
//   H=512:  k=16, 4 groups of 32 rows; w 132,096 B + 9 slots of 64
//           columns (all of h) = 205,824 B;
//   H=1280: k=10, 1 group of 128 rows; w 205,440 B + 3 slots of 16
//           columns = 230,016 B.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace lstm {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxTiles = 8;         // n-tiles a warp may own
constexpr int kMaxStages = 16;       // ring slots

// the work split, as kernels/lstm.py's PLAN_FIELDS orders it
struct Plan {
  int k, nh, nb, Bs, wm, wn, ntw, kc, stages, hp, kp, w_smem, ring_off,
      stage_floats, smem, grid;
};

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
  float* hbuf;                       // [2, B, hp], zero padded
  unsigned int* counters;            // [nb], zeroed before the launch
  int B, T, H, reverse, act_gate, act_cell, act_cand;
  Plan pl;
};

// accurate expf and tanhf: the fast forms cost as much here (measured)
// and tanh as 2 sigmoid(2v) - 1 moved the RNN benchmark's gradients
// past the card-vs-CPU tolerance
__device__ __forceinline__ float act(int code, float v) {
  switch (code) {
    case 0: return 1.f / (1.f + expf(-v));
    case 1: return tanhf(v);
    case 2: return fmaxf(v, 0.f);
    default: return v;
  }
}

// v ~ hi + lo in TF32 (10 mantissa bits): hi rounds to nearest, ties away
// (as cvt.rna.tf32.f32 does), v - hi is exact, and the tensor core reads
// lo's top 10 mantissa bits (truncation), so |v - hi - lo| < 2^-21 |v|.
// Three full-rate operations: cvt is a slow instruction, and this runs
// for every operand element
__device__ __forceinline__ void split(uint32_t v, uint32_t& hi,
                                      uint32_t& lo) {
  hi = (v + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(v) - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// four 8x(4 x 32-bit) matrices: lane l names row l%8 of matrix l/8 and
// gets word l%4 of row l/4 of each, which is the fragment layout of
// mma.m16n8k8.tf32 (A: the 4 matrices; B: 2 of them)
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm2(uint32_t& r0, uint32_t& r1,
                                      uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(a));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared through L2 only; zero-filled when !valid
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// wait until at most n of this thread's copy groups are pending
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: cp_wait_n<0>(); break;    case 1: cp_wait_n<1>(); break;
    case 2: cp_wait_n<2>(); break;    case 3: cp_wait_n<3>(); break;
    case 4: cp_wait_n<4>(); break;    case 5: cp_wait_n<5>(); break;
    case 6: cp_wait_n<6>(); break;    case 7: cp_wait_n<7>(); break;
    case 8: cp_wait_n<8>(); break;    case 9: cp_wait_n<9>(); break;
    case 10: cp_wait_n<10>(); break;  case 11: cp_wait_n<11>(); break;
    case 12: cp_wait_n<12>(); break;  case 13: cp_wait_n<13>(); break;
    default: cp_wait_n<14>(); break;
  }
}

// The step barrier of one batch group.  The counter only grows: after
// phase n every block of the group has arrived n times.  bar.sync orders
// the block's writes of h before thread 0's release; thread 0's acquire
// orders the group's writes before the block's reads after bar.sync.
__device__ __forceinline__ void arrive(unsigned int* ctr) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n"
                 :: "l"(ctr) : "memory");
}

__device__ __forceinline__ void wait_for(const unsigned int* ctr,
                                         unsigned int target) {
  if (threadIdx.x == 0) {
    unsigned int v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(v) : "l"(ctr) : "memory");
    } while (v < target);
  }
  __syncthreads();
}

// NTW: n-tiles a warp owns; WS: the weight slice sits in shared memory
template <int NTW, bool WS>
__global__ void __launch_bounds__(kThreads, 1) lstm_fwd_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const Plan& q = p.pl;
  const int H = p.H, T = p.T, k = q.k, N = 4 * k, NT = k / 2;
  const int ub = blockIdx.x % q.nh, bg = blockIdx.x / q.nh;
  const int u0 = ub * k, b0 = bg * q.Bs;
  const int kk = min(k, H - u0);               // units of this block
  const int bs = min(q.Bs, p.B - b0);          // rows of this block
  float* ws = smem;                            // [4k][kp] if w_smem
  float* ring = smem + q.ring_off;             // stages x [16 wm][kc]

  // w(j, n) for slice column n = du*4 + gate, zero outside the slice
  auto wg = [&](int j, int n) {
    const int du = n >> 2;
    return (j < H && du < kk)
        ? __ldg(p.w + (size_t)j * 4 * H + (n & 3) * H + u0 + du) : 0.f;
  };
  // the slice n-major (row n = column n of the slice, k contiguous) so
  // that ldmatrix reads B fragments; kp = 4 mod 8 words: conflict-free
  if (WS) {
#pragma unroll 8
    for (int idx = threadIdx.x; idx < q.hp * N; idx += kThreads) {
      const int j = idx / N, n = idx - j * N;
      ws[n * q.kp + j] = wg(j, n);
    }
  }

  // fragment roles: warp (mw, nw) owns m-tile mw and n-tiles
  // nw*NTW .. +NTW-1; after the exchange lane (g, t) owns row
  // mw*16 + g (+8 for odd t) and unit 2*tile + t/2 of each n-tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int mw = warp % q.wm, nw = warp / q.wm;
  const bool computes = nw < q.wn;
  const bool odd = tq & 1;
  const int row = mw * 16 + gq + (odd ? 8 : 0);
  const int b = b0 + row;
  const bool row_ok = computes && row < bs;
  const int len = row_ok ? p.lengths[b] : 0;
  bool own[NTW];
  int uu[NTW];
  float hc[NTW], cc[NTW], bv[NTW][4], pv[NTW][3];
#pragma unroll
  for (int i = 0; i < NTW; ++i) {
    const int nt = nw * NTW + i, du = nt * 2 + (tq >> 1);
    own[i] = row_ok && nt < NT && du < kk;
    const int u = uu[i] = u0 + du;
    hc[i] = cc[i] = 0.f;
#pragma unroll
    for (int g = 0; g < 4; ++g) bv[i][g] = own[i] ? p.bias[g * H + u] : 0.f;
#pragma unroll
    for (int g = 0; g < 3; ++g)
      pv[i][g] = (own[i] && p.peep) ? p.peep[g * H + u] : 0.f;
    if (own[i]) {
      if (p.h0) hc[i] = p.h0[(size_t)b * H + u];
      if (p.c0) cc[i] = p.c0[(size_t)b * H + u];
      __stcg(p.hbuf + (size_t)b * q.hp + u, hc[i]);
    }
  }
  unsigned int* ctr = p.counters + bg;
  arrive(ctr);

  const size_t BH = (size_t)p.B * q.hp;
  const int nc = q.hp / q.kc, ppr = q.kc / 4, pieces = 16 * q.wm * ppr;
  const int lg_ppr = __ffs(ppr) - 1;
  // ring rows are kc floats, unpadded; the 16-byte pieces of row r sit
  // XOR-swizzled so that the 8 rows an A fragment reads at one column
  // fall in 8 different 4-bank groups.  swz(r + 8) == swz(r).
  const int lg_rpl = __ffs(max(1, 32 / q.kc)) - 1, npc = min(ppr, 8);
  auto swz = [&](int r) { return (r >> lg_rpl) & (npc - 1); };
  // ldmatrix row addresses: A, lane l -> row l%8 (+8 for matrices 1, 3)
  // of this warp's m-tile, k quad +1 for matrices 2, 3; B, lane l ->
  // slice row l%8 of the n-tile, k quad +1 for matrix 1
  const int sw = swz(lane & 7), a_kq = lane >> 4;
  const uint32_t a_row = smem_addr(
      ring + (mw * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * q.kc);
  const uint32_t b_row = smem_addr(
      ws + (lane & 7) * q.kp + 4 * ((lane >> 3) & 1));
  // blocks of a batch group start on different chunks of h, so that
  // they do not all ask the same L2 lines at once
  const int rot = ub % nc;
  for (int s = 0; s < T; ++s) {
    const int t = p.reverse ? T - 1 - s : s;
    const bool valid = t < len;
    // x_t does not depend on h: load it before the wait
    float xv[NTW][4];
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      const float* xr = p.x + ((size_t)b * T + t) * 4 * H + uu[i];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        xv[i][g] = (own[i] && valid) ? __ldcs(xr + g * H) : 0.f;
    }
    wait_for(ctr, (unsigned int)(s + 1) * q.nh);

    const float* cur = p.hbuf + (s & 1) * BH;
    float* nxt = p.hbuf + ((s + 1) & 1) * BH;
    // the block's h rows of chunk (c + rot) % nc -> ring slot c % stages
    // (one copy group a call, empty past the last chunk, so the wait
    // count stays fixed)
    auto fetch = [&](int c) {
      if (c < nc) {
        float* dst = ring + (c % q.stages) * q.stage_floats;
        const int col = (c + rot < nc ? c + rot : c + rot - nc) * q.kc;
        for (int idx = threadIdx.x; idx < pieces; idx += kThreads) {
          const int r = idx >> lg_ppr, pc = idx & (ppr - 1);
          const bool v = r < bs;
          cp16(dst + r * q.kc + 4 * (pc ^ swz(r)),
               cur + (size_t)(b0 + (v ? r : 0)) * q.hp + col + pc * 4, v);
        }
      }
      cp_commit();
    };
    for (int c = 0; c < q.stages - 1; ++c) fetch(c);

    float acc[NTW][4], acc_hl[NTW][4], acc_lh[NTW][4];
#pragma unroll
    for (int i = 0; i < NTW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = acc_hl[i][e] = acc_lh[i][e] = 0.f;

    for (int c = 0; c < nc; ++c) {
      cp_wait(q.stages - 2);                   // this thread's part of c
      __syncthreads();                         // everyone's; c-1 consumed
      fetch(c + q.stages - 1);                 // into c-1's slot
      if (!computes) continue;
      const uint32_t hs = a_row + 4u * (c % q.stages) * q.stage_floats;
      const int jc = (c + rot < nc ? c + rot : c + rot - nc) * q.kc;
      // raw fragments of k-step k8: A from the ring, B from the slice.
      // No branch per tile: a warp's tiles past NT (when the warps do not
      // split the tiles evenly) load the last real tile and are never
      // stored, so loads and products of all tiles interleave freely
      auto load = [&](int k8, uint32_t (&fa)[4], uint32_t (&fb)[NTW][2]) {
        ldsm4(fa, hs + 16u * (((k8 >> 2) + a_kq) ^ sw));
#pragma unroll
        for (int i = 0; i < NTW; ++i) {
          const int nt = min(nw * NTW + i, NT - 1), j = jc + k8;
          if (WS) {
            ldsm2(fb[i][0], fb[i][1], b_row + 4u * (nt * 8 * q.kp + j));
          } else {
            fb[i][0] = __float_as_uint(wg(j + tq, nt * 8 + gq));
            fb[i][1] = __float_as_uint(wg(j + tq + 4, nt * 8 + gq));
          }
        }
      };
      auto product = [&](const uint32_t (&fa)[4], const uint32_t (&fb)[NTW][2]) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(fa[e], ah[e], al[e]);
#pragma unroll
        for (int i = 0; i < NTW; ++i) {
          uint32_t bh0, bl0, bh1, bl1;
          split(fb[i][0], bh0, bl0);
          split(fb[i][1], bh1, bl1);
          mma(acc_lh[i], al, bh0, bh1);
          mma(acc_hl[i], ah, bl0, bl1);
          mma(acc[i], ah, bh0, bh1);
        }
      };
      // two fragment sets in turn: the loads of one k-step are in flight
      // while the other's products run
      // (kc is a multiple of 16)
      uint32_t fa0[4], fa1[4], fb0[NTW][2], fb1[NTW][2];
      load(0, fa0, fb0);
      for (int k8 = 0; k8 < q.kc; k8 += 16) {
        load(k8 + 8, fa1, fb1);
        product(fa0, fb0);
        if (k8 + 16 < q.kc) load(k8 + 16, fa0, fb0);
        product(fa1, fb1);
      }
    }

    if (computes) {
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        if (nw * NTW + i >= NT) break;
        float a[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          a[e] = acc[i][e] + (acc_hl[i][e] + acc_lh[i][e]);
        // even lanes hold gates (c~, i) of rows g, g+8; odd lanes (f, o):
        // swap so even lanes keep row g and odd lanes row g+8
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
        if (!own[i]) continue;
        if (valid) {                           // else the carry is frozen
          const float ac = odd ? r0 : a[0], ai = odd ? r1 : a[1];
          const float af = odd ? a[2] : r0, ao = odd ? a[3] : r1;
          const float gc = (xv[i][0] + ac) + bv[i][0];
          float gi = (xv[i][1] + ai) + bv[i][1];
          float gf = (xv[i][2] + af) + bv[i][2];
          float go = (xv[i][3] + ao) + bv[i][3];
          const float cp = cc[i];
          gi += pv[i][0] * cp;
          gf += pv[i][1] * cp;
          const float ig = act(p.act_gate, gi), fg = act(p.act_gate, gf);
          cc[i] = fg * cp + ig * act(p.act_cand, gc);
          go += pv[i][2] * cc[i];
          hc[i] = act(p.act_gate, go) * act(p.act_cell, cc[i]);
        }
        __stcg(nxt + (size_t)b * q.hp + uu[i], hc[i]);
      }
    }
    // the next step waits for h alone: h and c of step t are stored
    // after the arrival, so the release does not wait for them
    if (s + 1 < T) arrive(ctr);
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      if (!own[i]) continue;
      const size_t o = ((size_t)b * T + t) * H + uu[i];
      __stcs(p.h_out + o, valid ? hc[i] : 0.f);
      __stcs(p.c_out + o, valid ? cc[i] : 0.f);
    }
  }
}

template <int NTW, bool WS>
int launch(const Params& p, cudaStream_t st) {
  const void* fn = (const void*)lstm_fwd_kernel<NTW, WS>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, p.pl.smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                    p.pl.smem);
  if (e != cudaSuccess) return (int)e;
  if ((long long)per_sm * sms < p.pl.grid)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  // a cooperative launch (every block resident at once, which the
  // per-group barriers need) through the launch attribute: stream
  // capture records it as a kernel node that keeps the attribute, so a
  // CUDA graph of the training step replays it cooperatively
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;
  coop[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.pl.grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)p.pl.smem;
  cfg.stream = st;
  cfg.attrs = coop;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, lstm_fwd_kernel<NTW, WS>, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace lstm

extern "C" {

// out[0] = SMs, out[1] = shared memory a block may opt into (bytes) of
// card `dev`: what the planner in kernels/lstm.py sizes the split for.
int lstm_fwd_limits(int dev, int* out) {
  cudaError_t e = cudaDeviceGetAttribute(
      &out[0], cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(
      &out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// Pointers as described at the top; peep, h0 and c0 may be null.  hbuf
// is [2, B, hp] zeroed scratch and counters nb zeroed uint32; plan holds
// kernels/lstm.py's PLAN_FIELDS in order.  Returns the CUDA error of the
// launch (0 on success); a plan outside the kernel's range is refused.
int lstm_fwd(const float* x, const float* w, const float* bias,
             const float* peep, const float* h0, const float* c0,
             const int* lengths, float* h_out, float* c_out, float* hbuf,
             unsigned int* counters, int B, int T, int H, int reverse,
             int act_gate, int act_cell, int act_cand, const int* plan,
             void* stream) {
  lstm::Plan pl;
  static_assert(sizeof(lstm::Plan) == 16 * sizeof(int), "plan layout");
  int* dst = reinterpret_cast<int*>(&pl);
  for (int i = 0; i < 16; ++i) dst[i] = plan[i];
  const bool ok = pl.k >= 2 && pl.k % 2 == 0 && pl.wm >= 1 &&
                  pl.wm * pl.wn <= lstm::kThreads / 32 && pl.ntw >= 1 &&
                  pl.ntw <= lstm::kMaxTiles && pl.wn * pl.ntw * 2 >= pl.k &&
                  pl.Bs <= 16 * pl.wm && pl.kc % 16 == 0 && pl.kc <= 64 &&
                  pl.stages >= 2 && pl.stages <= lstm::kMaxStages &&
                  pl.hp % pl.kc == 0 && pl.hp >= H && pl.kp >= pl.hp && pl.kp % 8 == 4 &&
                  pl.stage_floats >= 16 * pl.wm * pl.kc &&
                  pl.nh * pl.k >= H && pl.nb * pl.Bs >= B &&
                  pl.grid == pl.nh * pl.nb;
  if (!ok) return (int)cudaErrorInvalidValue;
  const lstm::Params p{x, w, bias, peep, h0, c0, lengths, h_out, c_out,
                       hbuf, counters, B, T, H, reverse, act_gate, act_cell,
                       act_cand, pl};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LSTM_LAUNCH(n)                                          \
  case n:                                                       \
    return pl.w_smem ? lstm::launch<n, true>(p, st)             \
                     : lstm::launch<n, false>(p, st);
  switch (pl.ntw) {
    LSTM_LAUNCH(1) LSTM_LAUNCH(2) LSTM_LAUNCH(3) LSTM_LAUNCH(4)
    LSTM_LAUNCH(5) LSTM_LAUNCH(6) LSTM_LAUNCH(7) LSTM_LAUNCH(8)
  }
#undef LSTM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
