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
// kept key (a dead lane, length 0) outputs 0.  A page id is clamped to
// the pool's rows, as XLA's gather clamps.  int8 values dequantize with
// the per-(row, slot) scale, bf16 values upcast to fp32; all arithmetic
// is fp32.
//
// Bound: the bytes of the live pages it reads.  A lane reads
// ceil(length / ps) * 2 * ps * D pool elements per head; q, out and the
// tables are small beside that.  At the serving path's shapes (B = 8,
// H = 8, D = 64, ps = 16) that is 0.4-1.5 us at 3.35 TB/s, below the
// time of launching a kernel at all; the arithmetic (4 * C * ps * D per
// live page and head) takes less still on the fp32 CUDA cores.  So the
// design is about latency and parallelism, not about either rate.
//
// Design (flash-decoding: the page walk split across blocks):
//   * grid (split, head, lane); split s walks pages [s * pps, (s + 1) *
//     pps) of its lane, below the lane's length.  pps (pages per split)
//     comes from the host (kernels/flash_attention.py `ragged_plan`),
//     which sizes the grid from B, H, P and the SM count only: the
//     lengths stay on the card, and reading them would be a sync.  A
//     split that starts past its lane's length writes an empty partial
//     and exits;
//   * each split keeps the online softmax's running max m, sum l and
//     kept-key flag per query row, and its [C, D] accumulator, and writes
//     them to a workspace the wrapper takes from torch's caching
//     allocator.  A second kernel merges the splits of each (lane, head)
//     by their log-sum-exp: m = -inf partials (empty splits) are skipped,
//     kept is OR-ed.  With one split the first kernel writes the output
//     itself and no merge runs;
//   * a page's K and V slabs come by cp.async in 16-byte pieces, raw in
//     the pool's type (bf16 and int8 dequantize from shared memory), into
//     a double buffer: the next page's copy runs under this page's
//     arithmetic, and the page id it needs was read from the table one
//     page earlier, so no copy waits on a table read.  q rides with the
//     first page's copy.  Rows are padded by 16 bytes, so the lanes that
//     read one column of neighbouring rows hit distinct banks.  A slab
//     whose rows are not whole 16-byte pieces is copied element by
//     element instead;
//   * scores: groups of kd lanes (kd a power of two, chosen so the block
//     has as many groups as dot products) each take one key against 4
//     query rows, kd lanes splitting D and reducing by shuffles; at
//     C = 1 that is 8 lanes a key, so all 4 warps share the page's 16
//     keys instead of one thread a row;
//   * softmax: a segment of lpr lanes a query row (lpr the page size
//     rounded up to a power of two, at most 32), so a warp takes 32 / lpr
//     rows at once; max and sum by shuffles inside the segment, the mask
//     and kept flag applied here.  Where the score phase has one lane a
//     key and a page's keys fill an aligned segment of a warp (a prefill
//     chunk, ps a power of two up to 32), the softmax runs right there on
//     the scores in registers, for 4 rows at once, and its own phase and
//     barrier drop out.  Every shuffle of the kernel takes the full mask
//     over a loop every lane of the warp runs: shuffles over part of a
//     warp (one mask a lane group) measured slower on the card;
//   * p.v: each thread owns 4 columns (one vector) of up to 4 rows of the
//     accumulator, which lives in shared memory across pages, and loads
//     each V vector once for all of them; when the rows leave threads
//     idle (C * D / 4 below the block size), kg key groups each keep a
//     partial accumulator (summed at the end), so a decode row's 16
//     vectors use all 128 threads;
//   * the merge: one block per (head, lane, 4 query rows); a warp a row
//     turns the splits' (m, l, kept) into weights, then each thread sums
//     one vector of the output over the splits.  It is launched as a
//     programmatic dependent of the split kernel (griddepcontrol), so
//     its blocks are resident and waiting when the splits finish.
//
// Measured on the card (chip_smoke.py, PERF.md): the split kernel's time
// goes to latency chains, not to bytes or arithmetic -- the lane's
// length and page ids, then the page, then two or three short phases
// with a barrier each, one warp a scheduler -- so one page a split at
// the serving shapes, many blocks in flight, is the fastest split.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;            // query rows per score item
constexpr float kMasked = -1e9f;

struct Params {
  const float* q;
  const void* pool;
  const float* scales;
  const int* table;
  const int* lengths;
  const int* q_base;
  float* out;
  float* ws;      // [B, H, S, C, D] acc, then [B, H, S, C] m, l, kept
  int B, C, H, R, ps, D, P, layer, n_layer, causal;
  float sm_scale;
  int pps, S;     // pages per split, splits
};

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ constexpr int floor_pow2(int x) {
  int p = 1;
  while (p * 2 <= x) p *= 2;
  return p;
}

__host__ __device__ constexpr int ceil_pow2(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// lanes splitting one score's dot product: enough groups for the
// block's items, at most 8, at most the row's vector count
__host__ __device__ inline int dot_lanes(int C, int ps, int D, int vw) {
  const int items = (C + kRows - 1) / kRows * ps;
  const int kd = items >= kThreads ? 1 : floor_pow2(kThreads / items);
  return imin(imin(kd, 8), floor_pow2(D / vw));
}

// thread slots over one row's D / vw vectors in the p.v phase
__host__ __device__ inline int pv_slots(int D, int vw) {
  return imax(1, kThreads / (D / vw));
}

// key groups of the p.v accumulator, each with a partial [C, D]: the
// slots a row would leave idle take a share of its keys instead
__host__ __device__ inline int key_groups(int C, int ps, int D, int vw) {
  return imin(floor_pow2(ps), floor_pow2(imax(1, pv_slots(D, vw) / C)));
}

// elements of T in one padded shared-memory row: whole 16-byte pieces
// plus one
__host__ __device__ inline int row_stride(int D, int item) {
  return ((D * item + 15) / 16 * 16 + 16) / item;
}

__host__ __device__ inline size_t up4(size_t n) { return (n + 3) / 4 * 4; }

__host__ __device__ inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

struct Smem {
  size_t slabs, scales, q, s, acc, stats, total;  // byte offsets
};

__host__ __device__ inline Smem smem_layout(int C, int ps, int D, int item,
                                            bool int8, int vw) {
  Smem m;
  m.slabs = 0;
  m.scales = 4 * (size_t)ps * row_stride(D, item) * item;  // 2 x (K, V)
  m.q = m.scales + (int8 ? 4 * up4(ps) * 4 : 0);
  m.s = m.q + up4((size_t)C * D) * 4;
  m.acc = m.s + up4((size_t)C * ps) * 4;
  m.stats = m.acc + (size_t)key_groups(C, ps, D, vw) * C * D * 4;
  m.total = m.stats + 4 * up4(C) * 4;
  return m;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

// VW consecutive elements of T at p (aligned to VW elements) as floats
template <int VW, typename T>
__device__ __forceinline__ void load_vec(float (&v)[VW], const T* p) {
  if constexpr (VW == 4 && sizeof(T) == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (VW == 4 && sizeof(T) == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else if constexpr (VW == 4 && sizeof(T) == 1) {
    const char4 x = *reinterpret_cast<const char4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < VW; ++i) v[i] = to_float(p[i]);
  }
}

template <int VW>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VW]) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VW; ++i) p[i] = v[i];
  }
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// programmatic dependent launch: the merge kernel may be scheduled once
// every split block has started, and waits for the split kernel's
// memory before it reads the workspace
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// start copying logical page `page` (an id from the table) of head h
// into stage `st`: K slab, V slab (padded rows) and, for int8, their ps
// scales each; the caller commits the copy group
template <typename T>
__device__ void load_page(const Params& p, unsigned char* smem,
                          const Smem& lay, int h, int page, int st,
                          bool vec_copy) {
  const int ps = p.ps, D = p.D, rs = row_stride(D, sizeof(T));
  // clamp like XLA's gather, so a bad page id cannot read out of bounds
  long long krow = (static_cast<long long>(page) * p.n_layer + p.layer) * 2;
  krow = krow < 0 ? 0 : (krow > p.R - 2 ? p.R - 2 : krow);
  const T* kp = static_cast<const T*>(p.pool) +
                (static_cast<size_t>(h) * p.R + krow) * ps * D;
  T* dst = reinterpret_cast<T*>(smem + lay.slabs) + (size_t)st * 2 * ps * rs;
  if (vec_copy) {
    const int cpr = D * (int)sizeof(T) / 16;       // 16-byte pieces a row
    const int n = ps * cpr;                        // a slab's pieces
    for (int i = threadIdx.x; i < 2 * n; i += kThreads) {
      const int kv = i >= n;
      const int j = i - kv * n;
      const int r = j / cpr, c = j - r * cpr;
      const char* src = reinterpret_cast<const char*>(kp + kv * ps * D) +
                        (size_t)r * D * sizeof(T) + c * 16;
      char* d = reinterpret_cast<char*>(dst + (kv * ps + r) * rs) + c * 16;
      cp_async(d, src, 16);
    }
  } else {
    for (int i = threadIdx.x; i < 2 * ps * D; i += kThreads) {
      const int kv = i >= ps * D;
      const int j = i - kv * ps * D;
      const int r = j / D, c = j - r * D;
      dst[(kv * ps + r) * rs + c] = kp[kv * ps * D + j];
    }
  }
  if (p.scales != nullptr) {
    float* ds = reinterpret_cast<float*>(smem + lay.scales) + st * 2 * up4(ps);
    for (int i = threadIdx.x; i < 2 * ps; i += kThreads) {
      const int kv = i >= ps;
      const int s = i - kv * ps;
      cp_async(ds + kv * up4(ps) + s, p.scales + (krow + kv) * ps + s, 4);
    }
  }
}

// one block per (split, head, lane)
template <typename T, int VW>
__global__ void __launch_bounds__(kThreads)
ragged_split_kernel(const Params p, const int vec_copy) {
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int C = p.C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ps = p.ps, D = p.D, NQ = D / VW;
  const int rs = row_stride(D, sizeof(T));
  const bool int8 = p.scales != nullptr;
  const bool direct = p.S == 1;
  const Smem lay = smem_layout(C, ps, D, sizeof(T), int8, VW);
  launch_dependents();

  // the lane's length and the split's first two page ids, read together:
  // a split starts on a page of the table (split * pps < P)
  const int pg0 = split * p.pps;
  const int* tbl = p.table + static_cast<size_t>(b) * p.P;
  const int length = p.lengths[b];
  const int base = p.q_base[b];
  const int id0 = tbl[pg0];
  int next_id = pg0 + 1 < p.P ? tbl[pg0 + 1] : 0;
  const int n_live = length <= 0 ? 0 : min(p.P, (length + ps - 1) / ps);
  const int pg1 = min(pg0 + p.pps, n_live);
  // the block's rows in the workspace [B, H, S, C] and in out [B, C, H]
  const size_t wrow = ((static_cast<size_t>(b) * p.H + h) * p.S + split) * C;
  const size_t orow = static_cast<size_t>(b) * C;
  const size_t n_part = static_cast<size_t>(p.B) * p.H * p.S * C;
  float* ws_m = p.ws + n_part * D;
  float* ws_l = ws_m + n_part;
  float* ws_k = ws_l + n_part;

  if (pg0 >= pg1) {          // nothing of this lane to read here
    if (direct) {
      for (int i = tid; i < C * D; i += kThreads) {
        const int c = i / D, d = i - c * D;
        p.out[((orow + c) * p.H + h) * D + d] = 0.f;
      }
    } else {
      for (int c = tid; c < C; c += kThreads) {
        ws_m[wrow + c] = -INFINITY;
        ws_l[wrow + c] = 0.f;
        ws_k[wrow + c] = 0.f;
      }
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  const T* slabs = reinterpret_cast<const T*>(smem + lay.slabs);
  const float* sscale = reinterpret_cast<const float*>(smem + lay.scales);
  float* sq = reinterpret_cast<float*>(smem + lay.q);        // [C][D]
  float* ss = reinterpret_cast<float*>(smem + lay.s);        // [C][ps]
  float* sacc = reinterpret_cast<float*>(smem + lay.acc);    // [kg][C][D]
  float* sm = reinterpret_cast<float*>(smem + lay.stats);    // [C]
  float* sl = sm + up4(C);
  float* salpha = sl + up4(C);
  int* skept = reinterpret_cast<int*>(salpha + up4(C));

  // page ids run one page ahead of the copies, so no copy waits on a
  // table read
  load_page<T>(p, smem, lay, h, id0, 0, vec_copy);
  // q rides with page 0's copy where its rows are whole 16-byte pieces
  const float* qb = p.q + (orow * p.H + h) * D;
  if (VW == 4 && aligned16(p.q)) {
    for (int i = tid; i < C * NQ; i += kThreads) {
      const int c = i / NQ, u = i - c * NQ;
      cp_async(sq + c * D + u * 4, qb + static_cast<size_t>(c) * p.H * D +
                                       u * 4, 16);
    }
  } else {
    for (int i = tid; i < C * D; i += kThreads) {
      const int c = i / D, d = i - c * D;
      sq[i] = qb[static_cast<size_t>(c) * p.H * D + d];
    }
  }
  cp_commit();
  const int kg = key_groups(C, ps, D, VW);
  for (int i = tid; i < kg * C * D; i += kThreads) sacc[i] = 0.f;
  for (int c = tid; c < C; c += kThreads) {
    sm[c] = -INFINITY;
    sl[c] = 0.f;
    skept[c] = 0;
  }

  // scores: item = (kRows query rows, one key), kd lanes per item
  const int kd = dot_lanes(C, ps, D, VW);
  const int groups = kThreads / kd;
  const int group = tid / kd, sub = tid - group * kd;
  const int n_items = (C + kRows - 1) / kRows * ps;
  // one lane a key, and a page's keys in one aligned segment of a warp:
  // the softmax runs on the scores in registers, inside the score phase
  const bool fused = kd == 1 && ps <= 32 && 32 % ps == 0;
  const unsigned segbits = ps >= 32 ? 0xffffffffu
                                    : ((1u << ps) - 1u) << (lane & ~(ps - 1));
  // softmax: lpr lanes a row, 32 / lpr rows a warp at a time
  const int lpr = imin(32, ceil_pow2(ps));
  const int seg = lane / lpr, sl_lane = lane - seg * lpr;
  // p.v: thread = (slot, vector u of the row); slot = (key group g,
  // first row cs); the thread's rows are cs, cs + rstride, ...
  const int slots = pv_slots(D, VW);
  const int rstride = imax(1, slots / kg);
  const int slot = NQ >= kThreads ? 0 : tid / NQ;
  const int u0 = NQ >= kThreads ? tid : tid - slot * NQ;
  const int g = slot % kg, cs = slot / kg;
  const bool pv_active = slot < slots && cs < rstride;

  for (int pg = pg0; pg < pg1; ++pg) {
    const int st = (pg - pg0) & 1;
    // page pg has landed, and every thread is done with page pg - 1,
    // whose stage takes page pg + 1
    cp_wait_all();
    __syncthreads();
    if (pg + 1 < pg1) {
      load_page<T>(p, smem, lay, h, next_id, st ^ 1, vec_copy);
      cp_commit();
      if (pg + 2 < pg1) next_id = tbl[pg + 2];
    }
    const T* sk = slabs + (size_t)st * 2 * ps * rs;
    const T* sv = sk + ps * rs;
    const float* ksc = sscale + st * 2 * up4(ps);
    const float* vsc = ksc + up4(ps);

    // every lane runs every round (an item past the last is computed
    // and dropped), so the shuffles take the full mask
    const int p0 = pg * ps;
    for (int it0 = 0; it0 < n_items; it0 += groups) {
      const bool valid = it0 + group < n_items;
      const int it = imin(it0 + group, n_items - 1);
      const int rb = it / ps, s = it - rb * ps;
      const int r0 = rb * kRows;
      const int nr = min(kRows, C - r0);
      float dot[kRows] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int u = sub; u < NQ; u += kd) {
        float kv[VW];
        load_vec<VW>(kv, sk + s * rs + u * VW);
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          if (j < nr) {
            float qv[VW];
            load_vec<VW>(qv, sq + (r0 + j) * D + u * VW);
#pragma unroll
            for (int e = 0; e < VW; ++e) dot[j] = fmaf(qv[e], kv[e], dot[j]);
          }
        }
      }
      const float sc = int8 ? ksc[s] * p.sm_scale : p.sm_scale;
      if (fused) {
        // the online softmax of the item's rows over the page's keys:
        // a segment holds a row batch (items are whole row batches, so
        // a segment is valid or not as one), max and sum by shuffles
        // inside it, lane s == 0 updating the row's stats
        const int col = p0 + s;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int c = r0 + j;
          const bool row = valid && j < nr;
          const bool keep =
              row && col < length && (!p.causal || col <= base + c);
          const float x = keep ? dot[j] * sc : kMasked;
          float mx = x;
          for (int o = ps / 2; o > 0; o /= 2)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float m_prev = row ? sm[c] : 0.f;
          const float m_new = fmaxf(m_prev, mx);
          const float e = expf(x - m_new);
          float sum = e;
          for (int o = ps / 2; o > 0; o /= 2)
            sum += __shfl_xor_sync(0xffffffffu, sum, o);
          const bool any = (__ballot_sync(0xffffffffu, keep) & segbits) != 0;
          if (row) {
            ss[c * ps + s] = e;
            if (s == 0) {
              const float alpha = expf(m_prev - m_new);
              sl[c] = alpha * sl[c] + sum;
              sm[c] = m_new;
              salpha[c] = alpha;
              if (any) skept[c] = 1;
            }
          }
        }
      } else {
        // rows below min(kRows, C) only: a bound the whole block shares
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          for (int o = kd / 2; j < C && o > 0; o /= 2)
            dot[j] += __shfl_xor_sync(0xffffffffu, dot[j], o);
        if (sub == 0 && valid) {
#pragma unroll
          for (int j = 0; j < kRows; ++j)
            if (j < nr) ss[(r0 + j) * ps + s] = dot[j] * sc;
        }
      }
    }
    __syncthreads();

    // online softmax, unless the score phase ran it: every lane of a
    // warp runs every pass, so the shuffles (xor offsets below lpr stay
    // in the row's segment) and the ballot take the full mask
    for (int c0 = warp * (32 / lpr); !fused && c0 < C;
         c0 += kWarps * (32 / lpr)) {
      const int c = c0 + seg;
      float* row = ss + c * ps;
      float mx = -INFINITY;
      bool kept = false;
      if (c < C) {
        for (int s = sl_lane; s < ps; s += lpr) {
          const int col = p0 + s;
          const bool keep = col < length && (!p.causal || col <= base + c);
          const float x = keep ? row[s] : kMasked;
          row[s] = x;
          mx = fmaxf(mx, x);
          kept |= keep;
        }
      }
      for (int o = lpr / 2; o > 0; o /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = c < C ? sm[c] : 0.f;
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      if (c < C) {
        for (int s = sl_lane; s < ps; s += lpr) {
          const float e = expf(row[s] - m_new);
          row[s] = e;
          sum += e;
        }
      }
      for (int o = lpr / 2; o > 0; o /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const unsigned any = __ballot_sync(0xffffffffu, kept);
      if (c < C && sl_lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sl[c] = alpha * sl[c] + sum;
        sm[c] = m_new;
        salpha[c] = alpha;
        if ((any >> (seg * lpr)) & (lpr == 32 ? 0xffffffffu
                                               : (1u << lpr) - 1u))
          skept[c] = 1;
      }
    }
    if (!fused) __syncthreads();

    // acc = acc * alpha + p.v, up to 4 of the thread's rows at a time
    // against one load of each V vector
    if (pv_active) {
      for (int u = u0; u < NQ; u += kThreads) {
        for (int c0 = cs; c0 < C; c0 += 4 * rstride) {
          float acc[4][VW];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c0 + j * rstride;
            if (c < C) {
              load_vec<VW>(acc[j], sacc + (g * C + c) * D + u * VW);
              const float alpha = salpha[c];
#pragma unroll
              for (int e = 0; e < VW; ++e) acc[j][e] *= alpha;
            }
          }
#pragma unroll 4
          for (int s = g; s < ps; s += kg) {
            float vv[VW];
            load_vec<VW>(vv, sv + s * rs + u * VW);
            const float vs = int8 ? vsc[s] : 1.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = c0 + j * rstride;
              if (c < C) {
                const float pr = ss[c * ps + s] * vs;
#pragma unroll
                for (int e = 0; e < VW; ++e)
                  acc[j][e] = fmaf(pr, vv[e], acc[j][e]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c0 + j * rstride;
            if (c < C) store_vec<VW>(sacc + (g * C + c) * D + u * VW, acc[j]);
          }
        }
      }
    }
  }
  __syncthreads();

  // the split's partial, or with one split the output itself, a vector
  // at a time
  for (int i = tid; i < C * NQ; i += kThreads) {
    const int c = i / NQ, u = i - c * NQ;
    float a[VW], t[VW];
    load_vec<VW>(a, sacc + c * D + u * VW);
    for (int gg = 1; gg < kg; ++gg) {
      load_vec<VW>(t, sacc + (gg * C + c) * D + u * VW);
#pragma unroll
      for (int e = 0; e < VW; ++e) a[e] += t[e];
    }
    if (direct) {
#pragma unroll
      for (int e = 0; e < VW; ++e) a[e] = skept[c] ? a[e] / sl[c] : 0.f;
      store_vec<VW>(p.out + ((orow + c) * p.H + h) * D + u * VW, a);
    } else {
      store_vec<VW>(p.ws + (wrow + c) * D + u * VW, a);
    }
  }
  if (!direct) {
    for (int c = tid; c < C; c += kThreads) {
      ws_m[wrow + c] = sm[c];
      ws_l[wrow + c] = sl[c];
      ws_k[wrow + c] = skept[c] ? 1.f : 0.f;
    }
  }
}

constexpr int kMergeRows = 4;       // query rows a merge block takes

// one block per (head, lane, kMergeRows query rows): first each row's
// split weights w_s = exp(m_s - max m) / sum_s exp(m_s - max m) l_s, one
// warp a row and one lane a split (0 for an empty split, m = -inf, and
// for every split of a row no split kept a key for, which outputs 0);
// then out = sum_s w_s acc_s, vector by vector, every split's vector
// loaded (an empty split's is unset memory) and the zero weights'
// products dropped by a select, so the loads do not wait on each other
template <int VW>
__global__ void __launch_bounds__(kThreads)
ragged_merge_kernel(const Params p) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int c_beg = blockIdx.z * kMergeRows;
  const int C = p.C, D = p.D, S = p.S, NQ = D / VW;
  const int nc = min(kMergeRows, C - c_beg);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t n_part = static_cast<size_t>(p.B) * p.H * S * C;
  const float* ws_m = p.ws + n_part * D;
  const float* ws_l = ws_m + n_part;
  const float* ws_k = ws_l + n_part;
  const size_t bh0 = (static_cast<size_t>(b) * p.H + h) * S;
  extern __shared__ float sw[];                       // [nc][S]
  wait_for_primary();

  for (int r = warp; r < nc; r += kWarps) {
    const int c = c_beg + r;
    // lane s holds split s (and s + 32, ... past 32 splits)
    float ms = -INFINITY, ls = 0.f;
    bool kept = false;
    if (lane < S) {
      ms = ws_m[(bh0 + lane) * C + c];
      ls = ws_l[(bh0 + lane) * C + c];
      kept = ws_k[(bh0 + lane) * C + c] != 0.f;
    }
    float m = ms;
    for (int s = lane + 32; s < S; s += 32) {
      m = fmaxf(m, ws_m[(bh0 + s) * C + c]);
      kept |= ws_k[(bh0 + s) * C + c] != 0.f;
    }
    for (int o = 16; o > 0; o /= 2)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    kept = __any_sync(0xffffffffu, kept);
    const float w = ms == -INFINITY ? 0.f : expf(ms - m);
    float l = w * ls;
    for (int s = lane + 32; s < S; s += 32) {
      const float m2 = ws_m[(bh0 + s) * C + c];
      const float w2 = m2 == -INFINITY ? 0.f : expf(m2 - m);
      sw[r * S + s] = w2;
      l = fmaf(w2, ws_l[(bh0 + s) * C + c], l);
    }
    for (int o = 16; o > 0; o /= 2)
      l += __shfl_xor_sync(0xffffffffu, l, o);
    const float inv = kept ? 1.f / l : 0.f;
    if (lane < S) sw[r * S + lane] = w * inv;
    for (int s = lane + 32; s < S; s += 32) sw[r * S + s] *= inv;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nc * NQ; i += kThreads) {
    const int r = i / NQ, u = i - r * NQ;
    const int c = c_beg + r;
    float acc[VW];
#pragma unroll
    for (int e = 0; e < VW; ++e) acc[e] = 0.f;
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      const float w = sw[r * S + s];
      float a[VW];
      load_vec<VW>(a, p.ws + ((bh0 + s) * C + c) * D + u * VW);
#pragma unroll
      for (int e = 0; e < VW; ++e)
        acc[e] = w != 0.f ? fmaf(w, a[e], acc[e]) : acc[e];
    }
    store_vec<VW>(p.out + ((static_cast<size_t>(b) * C + c) * p.H + h) * D +
                      u * VW, acc);
  }
}

__global__ void empty_kernel() {}

// raise a kernel's dynamic shared memory limit past 48 KB, once per
// size: outside a launch that a CUDA graph may be capturing
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= 48 * 1024 || bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const bool int8 = p.scales != nullptr;
  // 4-element vectors where every row of out and of the workspace starts
  // on a 16-byte boundary
  const int vw = p.D % 4 == 0 && aligned16(p.out) && aligned16(p.ws) ? 4 : 1;
  const size_t smem = smem_layout(p.C, p.ps, p.D, sizeof(T), int8, vw).total;
  // whole 16-byte pieces per row, and 16-byte aligned slabs
  const int vec_copy = (p.D * sizeof(T)) % 16 == 0 && aligned16(p.pool);
  static size_t allowed[2] = {0, 0};
  void (*kernel)(Params, int) =
      vw == 4 ? &ragged_split_kernel<T, 4> : &ragged_split_kernel<T, 1>;
  cudaError_t err = allow_smem(kernel, smem, allowed[vw == 4]);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.S, p.H, p.B), kThreads, smem, stream>>>(p, vec_copy);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.S == 1) return err;
  void (*merge)(Params) =
      vw == 4 ? &ragged_merge_kernel<4> : &ragged_merge_kernel<1>;
  static size_t merge_allowed[2] = {0, 0};
  const size_t msmem = sizeof(float) * kMergeRows * p.S;
  err = allow_smem(merge, msmem, merge_allowed[vw == 4]);
  if (err != cudaSuccess) return err;
  // launched as a programmatic dependent of the split kernel, so its
  // launch overlaps the split kernel's tail
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.H, p.B, (p.C + kMergeRows - 1) / kMergeRows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = msmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, merge, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one split block needs, in bytes (the wrapper checks it
// against the card's per-block limit before launching).
size_t ragged_paged_attention_smem_bytes(int C, int ps, int D,
                                         int pool_dtype) {
  const int item = pool_dtype == 0 ? 4 : (pool_dtype == 1 ? 2 : 1);
  return smem_layout(C, ps, D, item, pool_dtype == 2, D % 4 == 0 ? 4 : 1)
      .total;
}

// pool_dtype: 0 fp32, 1 bf16, 2 int8 (int8 needs scales).  The page walk
// is split into ceil(P / pages_per_split) splits; with more than one,
// `workspace` holds B * H * splits * C * (D + 3) floats and a merge
// kernel follows (2 kernels a call, else 1).  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int ragged_paged_attention(const float* q, const void* pool,
                           const float* scales, const int* table,
                           const int* lengths, const int* q_base, float* out,
                           float* workspace, int B, int C, int H, int R,
                           int ps, int D, int P, int layer, int n_layer,
                           int causal, float sm_scale, int pages_per_split,
                           int pool_dtype, void* stream) {
  if (pages_per_split < 1 || P < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = (P + pages_per_split - 1) / pages_per_split;
  if (S > 1 && workspace == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // scales belong to int8 pools only
  const Params p{q,       pool,      pool_dtype == 2 ? scales : nullptr,
                 table,   lengths,   q_base,
                 out,     workspace, B,       C,     H,       R,
                 ps,      D,         P,       layer, n_layer, causal,
                 sm_scale, pages_per_split, S};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pool_dtype) {
    case 0:
      return static_cast<int>(launch<float>(p, s));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(p, s));
    case 2:
      if (scales == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch<int8_t>(p, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One empty kernel on `stream`: the floor under any launch's time, which
// chip_smoke.py measures the same way as the kernel's.
int ragged_paged_attention_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
