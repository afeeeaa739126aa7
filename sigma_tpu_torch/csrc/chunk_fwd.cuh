// The chunk-parallel forward scan shared by K1 and K2 (csrc/scan_g_fwd.cu),
// K8 (csrc/scan_cf.cu) and K10 (csrc/scan_img.cu). Per chain g, channel
// e, state n:
//     d_t = softplus(dt_t + bias_e)                 (softplus optional)
//     h_t = exp(d_t A_ne) h_{t-1} + d_t u_t B_tn    (fp32 state)
//     y_t = sum_n C_tn h_tn + D_e u_t (+ y_accum_t)
// walked first to last, or last to first in place.
//
// Three launches, on the chunk machinery of csrc/chunk.cuh:
//   chunk_scan_kernel<EMIT = false> — one block per (chunk of kChunk = 128
//     tokens, 32 channels, chain) scans its chunk from a zero state: each
//     lane folds kItems consecutive walk positions into one (a, b) pair of
//     h -> a h + b, a warp-shuffle scan composes the 32 lanes. It writes the
//     chunk's end state (hloc) and its sum of d per channel (sd): the decay
//     across a chunk is exp(A_ne sum_t d_t), so only sd crosses chunks.
//   carry_kernel — one thread per (chain, state, channel) walks the chunks
//     in the walk's order and replaces hloc with the state entering each
//     chunk: a fixed order, no atomics, so y and hck are bit-identical on a
//     rerun.
//   chunk_scan_kernel<EMIT = true> — scans each chunk again from its true
//     carry and writes y (+ D u, + y_accum) and, under CK, every checkpoint
//     entry of the chunk: hck[j] is h as the walk enters 32-token segment j
//     (physical tokens [32 j, 32 j + 32)), the state before token 32 j
//     forward, before its last token (or L - 1) reversed. A null hck (eval)
//     launches the instantiation without it, so serving pays nothing for
//     checkpoints.
// u, d, B, C and y pass through shared memory in walk order, so every
// global access is a row of 32 channels (or of the states) of one token —
// or, for a source whose tokens are contiguous (kTokenMajor: K8's
// channel-first layout), a run of the chunk's 128 tokens of one channel
// (or state), which the staging transposes into the same walk slots; A and
// the carries of the block's channels are staged there too, so the scan's
// inner loop reads no device memory. Tokens past L walk as identities
// (d = 0: a = 1, b = 0).
//
// State tiles. A block holds NT <= 16 states (4, 8 or 16). K1 and K2 take
// N <= NT. K10 takes N up to 256 with TILED: the block walks the states in
// tiles of NT, the partial y of each tile kept in shared memory by the
// thread that owns it (a fixed order), u and d staged once.
//
// Operand sources. The kernels are templates over a source S, defined by
// the calling file and derived from FwdArgs, with
//   bool rev(int g)            chain g walks last to first
//   View view(int b, int g)    the chain's operands, t its sequence
//                              position:
//     float u_at(t, e), dt_at(t, e) (raw, before the bias), b_at(t, n),
//     c_at(t, n) (n < N); void put_y(t, e, v) stores y (adding y_accum if
//     the source has one); void put_hck(j, n, e, v) stores entry j of the
//     chain's checkpoints (called only under CK; K8 keeps every 8th);
//   float a_at(g, n, e)        A of chain g (FwdArgs: A as (G, N, dg));
//   kTokenMajor                the staging order (FwdArgs: false).
// A null bias or D counts as zero (K8: the caller applies them).
// Chain instance z = b * G + g (blockIdx.z) indexes hloc and sd.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "chunk.cuh"

namespace chunk {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int kFwdChan = 32;      // channels per block
constexpr int kFwdThreads = 256;  // threads per block
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kFwdIlp = 2;        // states scanned together
static_assert(4 % kFwdIlp == 0, "the state tiles hold whole groups");

// What every source carries. hloc, sd: scratch of (chains, n_chunk, N, dg)
// and (chains, n_chunk, dg) fp32, chains = batch * G; hck may be null.
struct FwdArgs {
  static constexpr bool kTokenMajor = false;  // a source's rows are tokens
  const float* A;     // (G, N, dg), or as the source's a_at reads it
  const float* bias;  // (G, dg), may be null
  const float* Dk;    // (G, dg), may be null
  float* hloc;
  float* sd;
  float* hck;
  int G, L, dg, N, softplus, n_chunk;
  __device__ float a_at(int g, int n, int e) const {
    return A[((size_t)g * N + n) * dg + e];
  }
};

inline void set_fwd_args(FwdArgs& p, const float* A, const float* bias,
                         const float* Dk, float* hloc, float* sd, float* hck,
                         int G, int L, int dg, int N, int softplus,
                         int n_chunk) {
  p.A = A;
  p.bias = bias;
  p.Dk = Dk;
  p.hloc = hloc;
  p.sd = sd;
  p.hck = hck;
  p.G = G;
  p.L = L;
  p.dg = dg;
  p.N = N;
  p.softplus = softplus;
  p.n_chunk = n_chunk;
}

// EMIT false: the chunk's state from zero and sum of d. EMIT true: y and,
// under CK, the checkpoints. Warp w walks channels w, w + 8, w + 16, w + 24
// of the block's tile.
template <class S, int NT, bool EMIT, bool CK, bool TILED>
__global__ void __launch_bounds__(kFwdThreads)
chunk_scan_kernel(const S p) {
  extern __shared__ float smem[];
  constexpr int kLdC = kFwdChan + 1;  // u / d / y row pitch
  constexpr int kLdN = NT + 1;        // B / C row pitch
  float* us = smem;                   // kRows x kLdC: u, then y
  float* ds = us + kRows * kLdC;      // kRows x kLdC: d
  float* bs = ds + kRows * kLdC;      // kRows x kLdN
  float* cs = bs + kRows * kLdN;      // kRows x kLdN
  float* hs = cs + kRows * kLdN;      // NT x kFwdChan: carry in / state out
  float* as = hs + NT * kFwdChan;     // NT x kFwdChan: A of the tile
  float* hk = as + NT * kFwdChan;     // (kChunk / kSeg) x NT x kFwdChan (CK)
  float* ys = hk + (CK ? kChunk / kSeg * NT * kFwdChan : 0);  // kRows x kLdC
  const int c = blockIdx.x, e0 = blockIdx.y * kFwdChan;
  const int g = blockIdx.z % p.G, b = blockIdx.z / p.G;
  const int dg = p.dg, N = p.N, L = p.L;
  const int rev = p.rev(g);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t bg = (size_t)b * p.G + g;
  const size_t slab = (bg * p.n_chunk + c) * N * dg;  // hloc of this chunk
  const auto v = p.view(b, g);

  // stage the chunk's u and d in walk order
#pragma unroll 4
  for (int i = threadIdx.x; i < kChunk * kFwdChan; i += kFwdThreads) {
    const int k = S::kTokenMajor ? i % kChunk : i / kFwdChan;
    const int ch = S::kTokenMajor ? i / kChunk : i % kFwdChan, e = e0 + ch;
    const int t = phys(c, k, rev);
    float uv = 0.f, dv = 0.f;
    if (t < L && e < dg) {
      uv = v.u_at(t, e);
      dv = v.dt_at(t, e) + (p.bias ? p.bias[(size_t)g * dg + e] : 0.f);
      if (p.softplus) dv = softplus_f(dv);
    }
    us[slot(k) * kLdC + ch] = uv;
    ds[slot(k) * kLdC + ch] = dv;
  }

  for (int s0 = 0; s0 < (TILED ? N : 1); s0 += NT) {
    const int ns = TILED ? min(NT, N - s0) : N;  // states of this tile
    const bool last = !TILED || s0 + NT >= N;
    if (TILED && s0 > 0) __syncthreads();  // the last tile is written out
    for (int i = threadIdx.x; i < kChunk * NT; i += kFwdThreads) {
      const int k = S::kTokenMajor ? i % kChunk : i / NT;
      const int n = S::kTokenMajor ? i / kChunk : i % NT;
      const int t = phys(c, k, rev);
      const bool ok = t < L && n < ns;
      bs[slot(k) * kLdN + n] = ok ? v.b_at(t, s0 + n) : 0.f;
      if (EMIT) cs[slot(k) * kLdN + n] = ok ? v.c_at(t, s0 + n) : 0.f;
    }
    // A of the tile's states (zero past ns) and, emitting, their carries in
    for (int i = threadIdx.x; i < NT * kFwdChan; i += kFwdThreads) {
      const int n = i / kFwdChan, e = e0 + i % kFwdChan;
      const bool ok = n < ns && e < dg;
      as[i] = ok ? p.a_at(g, s0 + n, e) : 0.f;
      if (EMIT) hs[i] = ok ? p.hloc[slab + (size_t)(s0 + n) * dg + e] : 0.f;
    }
    __syncthreads();

    for (int ch = warp; ch < kFwdChan; ch += kFwdWarps) {
      const int e = e0 + ch;
      if (e >= dg) break;
      float dk[kItems], uk[kItems], yk[kItems];
      float dsum = 0.f;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int r = slot(lane * kItems + j) * kLdC + ch;
        dk[j] = ds[r];
        uk[j] = us[r];
        yk[j] = TILED && EMIT && s0 > 0 ? ys[r] : 0.f;
        dsum += dk[j];
      }
      // kFwdIlp states at a time, their scans interleaved; a state past ns
      // (odd N) has A = 0 and B = C = 0, so it stays zero and adds nothing
      for (int n0 = 0; n0 < ns; n0 += kFwdIlp) {
        float ak[kFwdIlp][kItems], bk[kFwdIlp][kItems], fa[kFwdIlp],
            fb[kFwdIlp];
#pragma unroll
        for (int q = 0; q < kFwdIlp; ++q) {
          const int n = n0 + q;
          const float an = as[n * kFwdChan + ch];
          fa[q] = 1.f;
          fb[q] = 0.f;
#pragma unroll
          for (int j = 0; j < kItems; ++j) {
            const int r = slot(lane * kItems + j) * kLdN + n;
            ak[q][j] = __expf(dk[j] * an);
            bk[q][j] = dk[j] * uk[j] * bs[r];
            fb[q] = fmaf(ak[q][j], fb[q], bk[q][j]);
            fa[q] *= ak[q][j];
          }
        }
        scan_up<kFwdIlp>(fa, fb, lane);
#pragma unroll
        for (int q = 0; q < kFwdIlp; ++q) {
          const int n = n0 + q;
          if (!EMIT) {
            if (lane == 31) hs[n * kFwdChan + ch] = fb[q];
            continue;
          }
          // exclusive prefix: the state before this lane's first token
          float xa = __shfl_up_sync(kFull, fa[q], 1);
          float xb = __shfl_up_sync(kFull, fb[q], 1);
          if (lane == 0) {
            xa = 1.f;
            xb = 0.f;
          }
          float h = fmaf(xa, hs[n * kFwdChan + ch], xb);
          if (CK && (lane * kItems) % kSeg == 0)
            hk[((lane * kItems / kSeg) * NT + n) * kFwdChan + ch] = h;
#pragma unroll
          for (int j = 0; j < kItems; ++j) {
            h = fmaf(ak[q][j], h, bk[q][j]);
            yk[j] = fmaf(cs[slot(lane * kItems + j) * kLdN + n], h, yk[j]);
          }
        }
      }
      if (EMIT && last) {
        const float d_e = p.Dk ? p.Dk[(size_t)g * dg + e] : 0.f;
#pragma unroll
        for (int j = 0; j < kItems; ++j)
          us[slot(lane * kItems + j) * kLdC + ch] = fmaf(d_e, uk[j], yk[j]);
      } else if (EMIT) {  // TILED: this thread's partial y, kept for the next
#pragma unroll
        for (int j = 0; j < kItems; ++j)
          ys[slot(lane * kItems + j) * kLdC + ch] = yk[j];
      } else if (s0 == 0) {
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          dsum += __shfl_xor_sync(kFull, dsum, off);
        if (lane == 0) p.sd[(bg * p.n_chunk + c) * dg + e] = dsum;
      }
    }
    __syncthreads();

    if (!EMIT) {
      for (int i = threadIdx.x; i < ns * kFwdChan; i += kFwdThreads) {
        const int n = i / kFwdChan, e = e0 + i % kFwdChan;
        if (e < dg) p.hloc[slab + (size_t)(s0 + n) * dg + e] = hs[i];
      }
    } else if (CK) {
      // segment entries at walk positions 0, kSeg, ...: physical token
      // phys(c, k) starts segment phys / kSeg in the walk's order (reversed,
      // a segment past L - 1 is entered at L - 1 with the same state, and
      // one wholly past L does not exist)
      const int n_ck = n_ck_of(L);
      for (int i = threadIdx.x; i < (kChunk / kSeg) * ns * kFwdChan;
           i += kFwdThreads) {
        const int s = i / (ns * kFwdChan), n = (i / kFwdChan) % ns;
        const int ch = i % kFwdChan, e = e0 + ch;
        const int j = phys(c, s * kSeg, rev) / kSeg;
        if (j < n_ck && e < dg)
          v.put_hck(j, s0 + n, e, hk[(s * NT + n) * kFwdChan + ch]);
      }
    }
  }
  if (!EMIT) return;
  for (int i = threadIdx.x; i < kChunk * kFwdChan; i += kFwdThreads) {
    const int k = S::kTokenMajor ? i % kChunk : i / kFwdChan;
    const int ch = S::kTokenMajor ? i / kChunk : i % kFwdChan, e = e0 + ch;
    const int t = phys(c, k, rev);
    if (t < L && e < dg) v.put_y(t, e, us[slot(k) * kLdC + ch]);
  }
}

// The carry into every chunk, in the walk's order: thread (chain, n, e)
// replaces hloc[c] (the chunk's state from zero) with the state entering
// chunk c, carry' = exp(A_ne sd[c]) carry + hloc[c], a fixed order.
template <class S>
__global__ void carry_kernel(const S p, int chains) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int dg = p.dg, N = p.N;
  if (i >= (size_t)chains * N * dg) return;
  const int e = i % dg, n = (i / dg) % N;
  const size_t bg = i / ((size_t)N * dg);
  const int g = bg % p.G;
  const float an = p.a_at(g, n, e);
  walk_carries(p.hloc + (bg * p.n_chunk * N + n) * dg + e,
               p.sd + bg * p.n_chunk * dg + e, (size_t)N * dg, dg, an,
               p.n_chunk, p.rev(g));
}

template <class S, int NT, bool EMIT, bool CK, bool TILED>
int launch_chunk_pass(const S& p, int chains, cudaStream_t stream) {
  constexpr size_t rows = kRows * (kFwdChan + 1);
  const size_t smem =
      sizeof(float) * (2 * rows + 2 * kRows * (NT + 1) + 2 * NT * kFwdChan +
                       (CK ? kChunk / kSeg * NT * kFwdChan : 0) +
                       (TILED && EMIT ? rows : 0));
  auto kernel = chunk_scan_kernel<S, NT, EMIT, CK, TILED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.n_chunk, (p.dg + kFwdChan - 1) / kFwdChan, chains);
  kernel<<<grid, kFwdThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The chunk states, the carries, the emission over `chains` = batch * G
// chain instances (at most 65,535). TILED for N > NT.
template <class S, int NT, bool TILED>
int launch_chunk_scan(const S& p, int chains, cudaStream_t stream) {
  int code = launch_chunk_pass<S, NT, false, false, TILED>(p, chains, stream);
  if (code) return code;
  const size_t threads = (size_t)chains * p.N * p.dg;
  carry_kernel<S><<<(threads + 255) / 256, 256, 0, stream>>>(p, chains);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return p.hck ? launch_chunk_pass<S, NT, true, true, TILED>(p, chains, stream)
               : launch_chunk_pass<S, NT, true, false, TILED>(p, chains,
                                                              stream);
}

}  // namespace chunk
