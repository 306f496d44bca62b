// Shared pieces of the flash-attention kernels for Hopper (sm_90a):
// the tile geometry, the per-tensor strides, the mask and the dropout
// hash.  Included by flash_attention_fwd.cu and flash_attention_bwd.cu;
// each of those builds into its own library.  The tensor-core and copy
// helpers are in flash_attention_mma.cuh.
//
// Tiles are BQ query rows by BK key rows.  Every kernel runs 4 warps a
// block, each owning 16 rows of the block's tile.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// the reference's DEFAULT_MASK_VALUE: masked scores are finite, so a row
// that sees only masked keys is recognised by m <= kMask / 2
constexpr float kMask = -0.7f * FLT_MAX;

// element strides of one [B, L, H, D] ('blhd') or [B, H, L, D] ('bhld')
// tensor; the last axis is contiguous
struct Strides {
  long long b, h, l;
};

// keep_scale of paddle_tpu/kernels/flash_attention.py, bit for bit, as a
// threshold test: a murmur3-style finalizer over the global (batch*head,
// row, col) position and the seed, in uint32 arithmetic that wraps
// modulo 2^32; the top 24 bits are the uniform value u = (x >> 8) *
// 2^-24, which is exact, so u >= rate exactly when x >> 8 >= ceil(rate *
// 2^24) (rate * 2^24 is exact in fp32).  An integer compare in place of
// a convert, a multiply and a float compare.  Returns 0 or 1 / (1 -
// rate).
__device__ __forceinline__ uint32_t keep_threshold(float rate) {
  return (uint32_t)ceilf(rate * 16777216.0f);
}

// the hash's three terms: row * kRowMul + col * kColMul, then xor with
// bh * kBhMul ^ seed (the key)
constexpr uint32_t kRowMul = 0x9E3779B1u;
constexpr uint32_t kColMul = 0x85EBCA77u;
constexpr uint32_t kBhMul = 0xC2B2AE3Du;

// kept?  pos = row * kRowMul + col * kColMul, key = bh * kBhMul ^ seed
__device__ __forceinline__ bool kept(uint32_t pos, uint32_t key,
                                     uint32_t thr) {
  uint32_t x = pos ^ key;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return (x >> 8) >= thr;
}

__device__ __forceinline__ float keep_of(uint32_t seed, uint32_t bh,
                                         uint32_t row, uint32_t col,
                                         uint32_t thr, float inv_keep) {
  return kept(row * kRowMul + col * kColMul, (bh * kBhMul) ^ seed, thr)
             ? inv_keep : 0.0f;
}

// kept under the causal mask and the key bound?  Positions are global
// (row_off / col_off place this call's blocks in the full sequence), the
// key bound is local, as in the reference's _tile_mask.  No branches:
// every element of a tile takes the same instructions.
__device__ __forceinline__ bool live(int r, int c, int Lk, int causal,
                                     int row_off, int col_off) {
  return (c < Lk) & ((causal == 0) | (row_off + r >= col_off + c));
}

// keys [0, n) of a query tile starting at q0: under the causal mask the
// keys past its last row's diagonal never count
__device__ __forceinline__ int live_keys(int q0, int Lq, int Lk, int causal,
                                         int row_off, int col_off) {
  if (!causal) return Lk;
  const int last_row = row_off + min(q0 + BQ, Lq) - 1;
  return max(0, min(Lk, last_row - col_off + 1));
}

// what the per-tile steps of a kernel (flash_attention_fwd.cu
// softmax_pv, flash_attention_bwd.cu dq_step / dkv_step) need besides
// their fragments: the thread's place in the block's tile (warp row wr,
// fragment coordinates g = lane / 4 and t = lane % 4), the masks and the
// dropout hash of the call
struct TileCtx {
  int bh, wr, g, t, Lk, causal, row_off, col_off;
  float sm_scale, inv_keep;
  uint32_t seed, thr;
};

}  // namespace flash
