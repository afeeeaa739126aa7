// Chunk-parallel machinery shared by the forward chunk scan
// (csrc/chunk_fwd.cuh: K1, K2, K8, K10) and the backward one
// (csrc/chunk_bwd.cuh: K3, K4, K11).
//
// Both cut a chain's sequence into chunks of kChunk = 128 physical tokens
// (aligned with the kSeg = 32-token checkpoint segments, the last chunk
// ragged). A block stages its chunk in walk order — walk position k of
// chunk c is physical token phys(c, k), last to first for `reverse` — and
// each lane of a warp takes kItems consecutive walk positions, folds them
// into one affine map x -> a x + b, and a warp-shuffle scan composes the
// 32 lanes' maps. The forward state composes with the walk (scan_up); the
// backward's adjoint composes against it (scan_down). What crosses chunks
// is carried by one thread per (chain, state, channel) in a fixed order
// (walk_carries).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace chunk {

constexpr int kSeg = 32;             // hck spacing in tokens
constexpr int kItems = 4;            // consecutive walk positions per lane
constexpr int kChunk = 32 * kItems;  // tokens per chunk
constexpr int kRows = kChunk + kChunk / kItems;  // staged walk slots
constexpr unsigned kFull = 0xffffffffu;
static_assert(kChunk % kSeg == 0, "chunks must align with hck segments");
static_assert(kSeg % kItems == 0, "a segment entry starts a lane's run");

// checkpoint segments of a sequence of L tokens
__host__ __device__ inline int n_ck_of(int L) { return (L + kSeg - 1) / kSeg; }

// log(1 + e^x) without overflow: max(x, 0) + log1p(e^-|x|)
__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(__expf(-fabsf(x)));
}

// chunk-local walk position k of chunk c is physical token phys(c, k)
__device__ __forceinline__ int phys(int c, int k, int reverse) {
  return reverse ? c * kChunk + kChunk - 1 - k : c * kChunk + k;
}

// staging slot of walk position k: lane l's run of kItems starts at
// l * (kItems + 1), so 32 lanes reading item j of their runs from rows of
// odd pitch hit 32 banks
__device__ __forceinline__ int slot(int k) { return k + k / kItems; }

// the sum over a warp's 32 lanes, in a fixed order
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// inclusive scans over groups of W lanes, the group's first lane first, of
// h -> a h + b, for Q independent maps at once (their shuffles interleave):
// lane l ends with the composition of lanes (l - l % W) .. l
template <int Q, int W = 32>
__device__ __forceinline__ void scan_up(float (&a)[Q], float (&b)[Q],
                                        int lane) {
#pragma unroll
  for (int off = 1; off < W; off *= 2) {
    float qa[Q], qb[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      qa[q] = __shfl_up_sync(kFull, a[q], off, W);
      qb[q] = __shfl_up_sync(kFull, b[q], off, W);
    }
    if (lane % W >= off) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        b[q] = fmaf(a[q], qb[q], b[q]);
        a[q] *= qa[q];
      }
    }
  }
}

// the same over all 32 lanes, lane 31 first: lane l ends with
// x -> f_l(f_{l+1}(... f_31(x))), its own map applied last
template <int Q>
__device__ __forceinline__ void scan_down(float (&a)[Q], float (&b)[Q],
                                          int lane) {
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    float qa[Q], qb[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      qa[q] = __shfl_down_sync(kFull, a[q], off);
      qb[q] = __shfl_down_sync(kFull, b[q], off);
    }
    if (lane + off < 32) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        b[q] = fmaf(a[q], qb[q], b[q]);
        a[q] *= qa[q];
      }
    }
  }
}

// The carries along one (chain, state, channel): loc[c * step] holds chunk
// c's map applied to zero, and the chunk's decay is exp(an * sd[c * sd_step])
// (the product of its a's); on return loc[c * step] holds what enters
// chunk c. Chunks are visited first to last, or last to first when `down`.
// kBatch chunks' loads are in flight at a time, then their sequential
// carry: a fixed order, no atomics, so a rerun gives the same bits.
__device__ __forceinline__ void walk_carries(float* loc, const float* sd,
                                             size_t step, size_t sd_step,
                                             float an, int n_chunk,
                                             bool down) {
  constexpr int kBatch = 8;
  float carry = 0.f;
  for (int w0 = 0; w0 < n_chunk; w0 += kBatch) {
    float local[kBatch], decay[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int w = w0 + j, c = down ? n_chunk - 1 - w : w;
      if (w < n_chunk) {
        local[j] = loc[c * step];
        decay[j] = __expf(an * sd[c * sd_step]);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int w = w0 + j, c = down ? n_chunk - 1 - w : w;
      if (w < n_chunk) {
        loc[c * step] = carry;
        carry = fmaf(decay[j], carry, local[j]);
      }
    }
  }
}

}  // namespace chunk
