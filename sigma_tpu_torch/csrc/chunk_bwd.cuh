// The chunk-parallel scan backward shared by K3 and K4 (csrc/scan_g_bwd.cu),
// K9 (csrc/scan_cf.cu) and K11 (csrc/scan_img.cu). The forward is
// csrc/chunk_fwd.cuh's; per chain g, channel e, state n:
//     d_t = softplus(dt_t + bias_e)        a_t = exp(d_t A_ne)
//     h_t = a_t h_{t-1} + d_t u_t B_tn     y_t = sum_n C_tn h_t + D_e u_t
// and given dy, with dh_t the cotangent of h_t (dh_t = C_t dy_t +
// a_{t+1} dh_{t+1}), walked against the forward's order:
//     du_t  = d_t sum_n dh_t B_tn + D_e dy_t
//     dd_t  = (sum_n dh_t A a_t h_{t-1} + u_t sum_n dh_t B_tn) sigmoid(.)
//     dA   += dh_t a_t h_{t-1} d_t          dB_tn = sum_e dh_t d_t u_t
//     dC_tn = sum_e h_t dy_t                dD += dy_t u_t, dbias += dd_t
// du here is the direct term; where the streams were projected from u
// (K4, K11), K5 adds the chain term.
//
// Three launches, on the chunk machinery of csrc/chunk.cuh:
//   adjoint_local_kernel — the sequence is cut into chunks of kChunk = 128
//     physical tokens, aligned with the 32-token checkpoint segments (the
//     last chunk ragged; tokens past L walk as identities, d = 0). One
//     block per (chunk, 32 channels, chain) stages the chunk in walk order
//     and, per channel and state, folds each lane's 4 walk positions of
//     the adjoint map x -> a_t (C_t dy_t + x) and composes the 32 lanes
//     against the walk (scan_down): the chunk's adjoint leaving its first
//     token from a zero adjoint at its exit (lam), and its sum of d (sd:
//     the adjoint decays across the chunk by exp(A_ne sum_t d_t)).
//   adjoint_carry_kernel — one thread per (chain, state, channel) walks the
//     chunks against the walk (walk_carries, the forward's carry in the
//     other direction) and leaves in lam the adjoint entering each chunk at
//     its exit: a fixed order, no atomics.
//   adjoint_emit_kernel — per (chunk, 32 channels, chain) again. h needs
//     no carry: hck holds h as the walk enters every 32-token segment, so
//     h is recomputed inside each segment (8 lanes, scan_up over 8-lane
//     groups). The adjoint is re-swept from the true exit adjoint
//     (scan_down) and every output formed per token: du (the direct term),
//     dd; dA, dbias, dD as per-chunk partials; dB, dC summed over the
//     block's channels (each warp over its 4 channels in registers, then
//     the 8 warps in order in shared memory) into per-channel-block
//     partials. The caller sums the partials in a fixed order, so a rerun
//     gives the same bits for all seven gradients.
// Every global access is a row of 32 channels (or of the states) of one
// token, staged through shared memory in walk order (slot) — or, for a
// source whose tokens are contiguous (kTokenMajor: K9's channel-first
// layout), each lane moves its kItems walk positions of a channel between
// device memory and its registers directly, one 16-byte access per channel
// (by element where the run is not aligned or is cut by L): u, d and dy
// are not staged at all, and B, C and the dB / dC partials are staged
// token-major (a run of the chunk's tokens per state); the thread's sums
// over the states then live in shared memory, which frees the registers
// the three take. There the shuffles' latency binds, so a token-major
// local pass composes all the tile's states over the lanes at once
// (compose_scatter: 2 shuffles a state, not scan_down's 10), and the
// emission sums a group's dA terms the same way (sum_scatter); both sum
// in another fixed order than warp_sum, so the other sources keep theirs
// and their bits. This fork of the reductions is temporary: whether K3,
// K4 and K11 gain from the token-major path's reductions and shared-memory
// sums is not measured (ROADMAP "Next in order" item 3), and the change
// that measures it keeps one reduction path for every source and records
// tests/fixtures/chunk_bwd_bits.json anew on purpose.
//
// State tiles. A block holds NT <= 16 states (4, 8 or 16). K3 and K4 take
// N <= NT. K11 takes N up to 256 with TILED: the block walks the states in
// tiles of NT, restaging B, C, A, the exit adjoints and the checkpoints of
// each tile; d, u and dy are staged once, and each thread keeps its
// channels' sum_n dh B and sum_n dh A a h in registers across the tiles
// (a fixed order), so du and dd leave once, after the last tile.
//
// Operand sources. The kernels are templates over a source S, defined by
// the calling file and derived from BwdArgs, with
//   bool rev(int g)            chain g walks last to first
//   View view(int b, int g)    the chain's operands, t its sequence
//                              position:
//     float u_at(t, e), dy_at(t, e), dt_at(t, e) (raw, before the bias);
//     void put_du(t, e, v), put_dd(t, e, v) — or, token-major, the runs of
//     channel e: const float* u_run(e), dy_run(e), dt_run(e), float*
//     du_run(e), dd_run(e), and bool vec (every run 16-byte aligned);
//     float b_at(t, n), c_at(t, n) (n < N); void put_dbc(blk, t, n, dB,
//     dC) stores channel block blk's partials; const float* hck, the
//     chain's (n_ck, N, dg) checkpoints;
//   float a_at(g, n, e)        A of chain g (BwdArgs: A as (G, N, dg));
//   kTokenMajor                the access order (BwdArgs: false).
// A null bias or D counts as zero; a null dbias or dD is not written (K9:
// the caller differentiates them).
// Chain instance z = b * G + g (blockIdx.z) indexes lam, sd and the
// per-chunk partials.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "chunk.cuh"

namespace chunk {

constexpr int kBwdChan = 32;      // channels per block
constexpr int kBwdThreads = 256;  // threads per block
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdPer = kBwdChan / kBwdWarps;  // channels per warp
constexpr int kBwdIlp = 2;                     // states scanned together
constexpr int kBwdLdC = kBwdChan + 1;  // row pitch of the staged channel rows
constexpr int kSegs = kChunk / kSeg;      // checkpoint segments a chunk
constexpr int kSegLanes = kSeg / kItems;  // lanes a segment
static_assert(4 % kBwdIlp == 0, "the state tiles hold whole groups");
static_assert(kItems == 4, "a lane's run is one float4");

// What every source carries. Scratch lam (chains, n_chunk, N, dg), sd
// (chains, n_chunk, dg); the per-chunk partials dA (chains, n_chunk, N,
// dg), dbias and dD (chains, n_chunk, dg); chains = batch * G.
struct BwdArgs {
  static constexpr bool kTokenMajor = false;  // a source's rows are tokens
  const float* A;     // (G, N, dg), or as the source's a_at reads it
  const float* bias;  // (G, dg), may be null
  const float* Dk;    // (G, dg), may be null
  float* lam;
  float* sd;
  float* dA;
  float* dbias;       // may be null
  float* dD;          // may be null
  int G, L, dg, N, softplus, n_chunk;
  __device__ float a_at(int g, int n, int e) const {
    return A[((size_t)g * N + n) * dg + e];
  }
};

inline void set_bwd_args(BwdArgs& p, const float* A, const float* bias,
                         const float* Dk, float* lam, float* sd, float* dA,
                         float* dbias, float* dD, int G, int L, int dg, int N,
                         int softplus, int n_chunk) {
  p.A = A;
  p.bias = bias;
  p.Dk = Dk;
  p.lam = lam;
  p.sd = sd;
  p.dA = dA;
  p.dbias = dbias;
  p.dD = dD;
  p.G = G;
  p.L = L;
  p.dg = dg;
  p.N = N;
  p.softplus = softplus;
  p.n_chunk = n_chunk;
}

// Stage chunk c of a chain in walk order: ds d = softplus(dt + bias) (or
// dt + bias), ys dy and, with FULL, us u. Tokens past L and channels past
// dg stage as zeros (d = 0: an identity step).
template <class S, bool FULL>
__device__ __forceinline__ void stage_channels(const S& p,
                                               const typename S::View& v,
                                               int c, int e0, int g, int rev,
                                               float* us, float* ds,
                                               float* ys) {
  const int dg = p.dg, L = p.L;
  for (int i = threadIdx.x; i < kChunk * kBwdChan; i += kBwdThreads) {
    const int k = i / kBwdChan, ch = i % kBwdChan, e = e0 + ch;
    const int t = phys(c, k, rev);
    float uv = 0.f, dv = 0.f, yv = 0.f;
    if (t < L && e < dg) {
      dv = v.dt_at(t, e) + (p.bias ? p.bias[(size_t)g * dg + e] : 0.f);
      if (p.softplus) dv = softplus_f(dv);
      yv = v.dy_at(t, e);
      if (FULL) uv = v.u_at(t, e);
    }
    const int r = slot(k) * kBwdLdC + ch;
    ds[r] = dv;
    ys[r] = yv;
    if (FULL) us[r] = uv;
  }
}

// Token-major: the first physical token of the lane's walk positions
// [lane kItems, lane kItems + kItems) of chunk c (reversed, its last)
__device__ __forceinline__ int run_start(int c, int lane, int rev) {
  return phys(c, lane * kItems + (rev ? kItems - 1 : 0), rev);
}

// the lane's kItems walk positions of a run into x, zero past L: one
// 16-byte load where the run is aligned and not cut by L
__device__ __forceinline__ void load_run(const float* run, int t0, int L,
                                         bool vec, int rev,
                                         float (&x)[kItems]) {
  float q[kItems];
  if (vec && t0 + kItems <= L) {
    const float4 w = *reinterpret_cast<const float4*>(run + t0);
    q[0] = w.x;
    q[1] = w.y;
    q[2] = w.z;
    q[3] = w.w;
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) q[j] = t0 + j < L ? run[t0 + j] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) x[j] = q[rev ? kItems - 1 - j : j];
}

// x (walk order) back to the lane's tokens of a run, none past L
__device__ __forceinline__ void store_run(float* run, int t0, int L, bool vec,
                                          int rev, const float (&x)[kItems]) {
  float q[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) q[rev ? kItems - 1 - j : j] = x[j];
  if (vec && t0 + kItems <= L) {
    *reinterpret_cast<float4*>(run + t0) = make_float4(q[0], q[1], q[2], q[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (t0 + j < L) run[t0 + j] = q[j];
  }
}

// Q sums over the 32 lanes at once (Q a power of two up to 32): the lanes
// swap halves of their terms 16, 8, ... apart until each holds one, then
// sum it over the rest; lane l ends with the sum of term l / (32 / Q).
// Q - 1 + 5 - log2(Q) shuffles, where Q warp sums take 5 Q; a fixed
// order. H terms are left at lane distance OFF (compile-time, so that
// the terms stay in registers).
template <int Q, int H = Q, int OFF = 16>
__device__ __forceinline__ void sum_scatter(float (&v)[Q], int lane) {
  static_assert(Q >= 1 && Q <= 32 && (Q & (Q - 1)) == 0, "Q a power of 2");
  if constexpr (OFF > 0) {
    constexpr int M = H > 1 ? H / 2 : 1;  // terms swapped
    const bool up = lane & OFF;
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const int kk = H > 1 ? k + M : k;  // the half this lane hands over
      const float send = up ? v[k] : v[kk];
      const float keep = up ? v[kk] : v[k];
      v[k] = keep + __shfl_xor_sync(kFull, send, OFF);
    }
    sum_scatter<Q, M, OFF / 2>(v, lane);
  }
}

// The same for Q adjoint maps x -> a x + b over the 32 lanes, each lane's
// map applied after the next lane's (as scan_down composes them): the
// lanes swap halves 1, 2, 4, ... apart, so each step composes adjacent
// runs of lanes, the lower run outermost. Lane l < Q ends with the
// composition of all 32 lanes of term compose_term<Q>(l).
template <int Q, int H = Q, int OFF = 1>
__device__ __forceinline__ void compose_scatter(float (&a)[Q], float (&b)[Q],
                                                int lane) {
  static_assert(Q >= 1 && Q <= 32 && (Q & (Q - 1)) == 0, "Q a power of 2");
  if constexpr (OFF < 32) {
    constexpr int M = H > 1 ? H / 2 : 1;  // terms swapped
    const bool up = lane & OFF;           // the later run of the two
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const int kk = H > 1 ? k + M : k;  // the half this lane hands over
      const float sa = up ? a[k] : a[kk], sb = up ? b[k] : b[kk];
      const float ka = up ? a[kk] : a[k], kb = up ? b[kk] : b[k];
      const float ra = __shfl_xor_sync(kFull, sa, OFF);
      const float rb = __shfl_xor_sync(kFull, sb, OFF);
      const float la = up ? ra : ka, lb = up ? rb : kb;  // the lower run
      const float ua = up ? ka : ra, ub = up ? kb : rb;  // the upper run
      a[k] = la * ua;
      b[k] = fmaf(la, ub, lb);
    }
    compose_scatter<Q, M, OFF * 2>(a, b, lane);
  }
}

template <int Q>
__device__ __forceinline__ int compose_term(int lane) {
  int k = 0;
#pragma unroll
  for (int bit = 1, w = Q / 2; w >= 1; bit *= 2, w /= 2)
    if (lane & bit) k += w;
  return k;
}

// Token-major: the lane's d (softplus(dt + bias) or dt + bias) and dy, and
// with FULL u, of channel e into registers; zeros past L and past dg
template <class S, bool FULL>
__device__ __forceinline__ void load_channel(const S& p,
                                             const typename S::View& v,
                                             int c, int e, int g, int rev,
                                             int lane, float (&uk)[kItems],
                                             float (&dk)[kItems],
                                             float (&yk)[kItems]) {
  const int L = p.L, t0 = run_start(c, lane, rev);
  if (e >= p.dg) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) uk[j] = dk[j] = yk[j] = 0.f;
    return;
  }
  load_run(v.dt_run(e), t0, L, v.vec, rev, dk);
  load_run(v.dy_run(e), t0, L, v.vec, rev, yk);
  if (FULL) load_run(v.u_run(e), t0, L, v.vec, rev, uk);
  const float bias = p.bias ? p.bias[(size_t)g * p.dg + e] : 0.f;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    // past L: d = 0, an identity step
    const bool ok = phys(c, lane * kItems + j, rev) < L;
    float dv = dk[j] + bias;
    if (p.softplus) dv = softplus_f(dv);
    dk[j] = ok ? dv : 0.f;
  }
}

// the tile's C (and with FULL, B) of states [s0, s0 + ns) in walk order,
// zero past ns and past L; token-major sources are read a run of the
// chunk's tokens per state
template <class S, int NT, bool FULL>
__device__ __forceinline__ void stage_states(const typename S::View& v, int c,
                                             int s0, int ns, int rev, int L,
                                             float* bs, float* cs) {
  constexpr int kLdN = NT + 1;
  for (int i = threadIdx.x; i < kChunk * NT; i += kBwdThreads) {
    const int k = S::kTokenMajor ? i % kChunk : i / NT;
    const int n = S::kTokenMajor ? i / kChunk : i % NT;
    const int t = phys(c, k, rev);
    const bool ok = t < L && n < ns;
    const int r = slot(k) * kLdN + n;
    cs[r] = ok ? v.c_at(t, s0 + n) : 0.f;
    if (FULL) bs[r] = ok ? v.b_at(t, s0 + n) : 0.f;
  }
}

// Pass 1: per (chunk, 32 channels, chain), the adjoint leaving the chunk's
// first walk position from a zero adjoint at its exit (lam) and the
// chunk's sum of d per channel (sd). Lane l holds walk positions 4l..4l+3;
// its map x -> a_{4l} (c_{4l} + a_{4l+1} (c_{4l+1} + ...)), c_t = C_t dy_t,
// x the adjoint arriving from lane l + 1, composes lane 31 first.
// Token-major sources read d and dy of each channel straight into the
// lanes' registers and stage only C.
template <class S, int NT, bool TILED>
__global__ void __launch_bounds__(kBwdThreads)
adjoint_local_kernel(const S p) {
  extern __shared__ float smem[];
  constexpr int kLdN = NT + 1;
  constexpr bool kTm = S::kTokenMajor;
  float* ds = smem;                  // kRows x kBwdLdC: d (not kTm)
  float* ys = ds + (kTm ? 0 : kRows * kBwdLdC);  // the same: dy
  float* cs = ys + (kTm ? 0 : kRows * kBwdLdC);  // kRows x kLdN: C
  float* ls = cs + kRows * kLdN;     // NT x kBwdChan: the chunk's adjoints
  const int c = blockIdx.x, e0 = blockIdx.y * kBwdChan;
  const int g = blockIdx.z % p.G, b = blockIdx.z / p.G;
  const int dg = p.dg, N = p.N;
  const int rev = p.rev(g);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t bg = (size_t)b * p.G + g;
  const size_t slab = (bg * p.n_chunk + c) * N * dg;
  const auto v = p.view(b, g);
  if constexpr (!kTm)
    stage_channels<S, false>(p, v, c, e0, g, rev, nullptr, ds, ys);

  for (int s0 = 0; s0 < (TILED ? N : 1); s0 += NT) {
    const int ns = TILED ? min(NT, N - s0) : N;  // states of this tile
    stage_states<S, NT, false>(v, c, s0, ns, rev, p.L, nullptr, cs);
    __syncthreads();
    for (int ch = warp; ch < kBwdChan; ch += kBwdWarps) {
      const int e = e0 + ch;
      if (e >= dg) break;
      float dk[kItems], yk[kItems];
      float dsum = 0.f;
      if constexpr (kTm) {
        float uk[kItems];
        load_channel<S, false>(p, v, c, e, g, rev, lane, uk, dk, yk);
      } else {
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const int r = slot(lane * kItems + j) * kBwdLdC + ch;
          dk[j] = ds[r];
          yk[j] = ys[r];
        }
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j) dsum += dk[j];
      if constexpr (kTm) {
        // the lane's maps of all the tile's states, composed over the lanes
        // in one compose_scatter (states past ns: A = 0, C = 0)
        float fa[NT], fb[NT];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float an = n < ns ? p.a_at(g, s0 + n, e) : 0.f;
          fa[n] = 1.f;
          fb[n] = 0.f;
#pragma unroll
          for (int j = kItems - 1; j >= 0; --j) {
            const float a = __expf(dk[j] * an);
            const float cv = cs[slot(lane * kItems + j) * kLdN + n] * yk[j];
            fb[n] = a * (fb[n] + cv);
            fa[n] *= a;
          }
        }
        compose_scatter<NT>(fa, fb, lane);
        if (lane < NT) ls[compose_term<NT>(lane) * kBwdChan + ch] = fb[0];
      } else {
        for (int n0 = 0; n0 < ns; n0 += kBwdIlp) {
          float fa[kBwdIlp], fb[kBwdIlp];
#pragma unroll
          for (int q = 0; q < kBwdIlp; ++q) {
            const int n = n0 + q;
            const float an = n < ns ? p.a_at(g, s0 + n, e) : 0.f;
            fa[q] = 1.f;
            fb[q] = 0.f;
#pragma unroll
            for (int j = kItems - 1; j >= 0; --j) {
              const float a = __expf(dk[j] * an);
              const float cv = cs[slot(lane * kItems + j) * kLdN + n] * yk[j];
              fb[q] = a * (fb[q] + cv);
              fa[q] *= a;
            }
          }
          scan_down<kBwdIlp>(fa, fb, lane);
          if (lane == 0) {
#pragma unroll
            for (int q = 0; q < kBwdIlp; ++q)
              ls[(n0 + q) * kBwdChan + ch] = fb[q];
          }
        }
      }
      if (s0 == 0) {
        dsum = warp_sum(dsum);
        if (lane == 0) p.sd[(bg * p.n_chunk + c) * dg + e] = dsum;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < ns * kBwdChan; i += kBwdThreads) {
      const int n = i / kBwdChan, e = e0 + i % kBwdChan;
      if (e < dg) p.lam[slab + (size_t)(s0 + n) * dg + e] = ls[i];
    }
  }
}

// Pass 2: lam[c] becomes the adjoint entering chunk c at its exit, the
// chunks walked against the walk.
template <class S>
__global__ void adjoint_carry_kernel(const S p, int chains) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int dg = p.dg, N = p.N;
  if (i >= (size_t)chains * N * dg) return;
  const int e = i % dg, n = (i / dg) % N;
  const size_t bg = i / ((size_t)N * dg);
  const int g = bg % p.G;
  const float an = p.a_at(g, n, e);
  walk_carries(p.lam + (bg * p.n_chunk * N + n) * dg + e,
               p.sd + bg * p.n_chunk * dg + e, (size_t)N * dg, dg, an,
               p.n_chunk, !p.rev(g));
}

// Pass 3: every output of chunk c from its exit adjoint (lam) and the
// checkpoints. Warp w takes channels w, w + 8, w + 16, w + 24; the states
// go in groups of kBwdIlp, each group's dB / dC channel sums reduced
// across the warps before the next group starts. A token-major source
// keeps u, d and dy of the thread's channels in registers for the whole
// block (no staging), and du / dd leave from them; to make room, the
// thread's sums over the states (sum_n dh B, sum_n dh A a h) live in its
// own slots of shared memory, added to once per channel and state group.
template <class S, int NT, bool TILED>
__global__ void __launch_bounds__(kBwdThreads, 2)
adjoint_emit_kernel(const S p) {
  extern __shared__ float smem[];
  constexpr int kLdN = NT + 1;
  constexpr bool kTm = S::kTokenMajor;
  constexpr int kStaged = kTm ? 0 : kRows * kBwdLdC;
  float* us = smem;                    // kRows x kBwdLdC: u, then du (not kTm)
  float* ds = us + kStaged;            // kRows x kBwdLdC: d, then dd (not kTm)
  float* ys = ds + kStaged;            // kRows x kBwdLdC: dy (not kTm)
  float* bs = ys + kStaged;            // kRows x kLdN: B, then dB
  float* cs = bs + kRows * kLdN;       // kRows x kLdN: C, then dC
  float* ls = cs + kRows * kLdN;       // NT x kBwdChan: exit adjoints
  float* as = ls + NT * kBwdChan;      // NT x kBwdChan: A
  float* hk = as + NT * kBwdChan;      // kSegs x NT x kBwdChan: checkpoints
  float* part = hk + kSegs * NT * kBwdChan;  // kBwdWarps x 2 x kBwdIlp
                                             // x kChunk
  const int c = blockIdx.x, blk = blockIdx.y, e0 = blk * kBwdChan;
  const int g = blockIdx.z % p.G, b = blockIdx.z / p.G;
  const int dg = p.dg, N = p.N, L = p.L;
  const int rev = p.rev(g);
  const int n_ck = n_ck_of(L);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t bg = (size_t)b * p.G + g;
  const size_t slab = (bg * p.n_chunk + c) * N * dg;
  const auto v = p.view(b, g);
  float ur[kBwdPer][kItems], dr[kBwdPer][kItems], yr[kBwdPer][kItems];
  if constexpr (kTm) {
#pragma unroll
    for (int i = 0; i < kBwdPer; ++i)
      load_channel<S, true>(p, v, c, e0 + warp + kBwdWarps * i, g, rev, lane,
                            ur[i], dr[i], yr[i]);
  } else {
    stage_channels<S, true>(p, v, c, e0, g, rev, us, ds, ys);
  }

  float sb[kBwdPer][kItems], sa[kBwdPer][kItems];  // sum_n dh B, dh A a h
  // token-major: the same sums in the thread's slots, 2 x kBwdPer x kItems
  // x kBwdThreads
  float* sums = part + kBwdWarps * 2 * kBwdIlp * kChunk;
  auto sum_at = [&](int which, int i, int j) -> float& {
    return sums[((which * kBwdPer + i) * kItems + j) * kBwdThreads +
                threadIdx.x];
  };
#pragma unroll
  for (int i = 0; i < kBwdPer; ++i)
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      sb[i][j] = sa[i][j] = 0.f;
      if constexpr (kTm) sum_at(0, i, j) = sum_at(1, i, j) = 0.f;
    }
  const int seg = lane / kSegLanes;
  for (int s0 = 0; s0 < (TILED ? N : 1); s0 += NT) {
    const int ns = TILED ? min(NT, N - s0) : N;  // states of this tile
    if (TILED && s0 > 0) __syncthreads();  // the last tile is written out
    stage_states<S, NT, true>(v, c, s0, ns, rev, L, bs, cs);
    for (int i = threadIdx.x; i < NT * kBwdChan; i += kBwdThreads) {
      const int n = i / kBwdChan, e = e0 + i % kBwdChan;
      const bool ok = n < ns && e < dg;
      ls[i] = ok ? p.lam[slab + (size_t)(s0 + n) * dg + e] : 0.f;
      as[i] = ok ? p.a_at(g, s0 + n, e) : 0.f;
    }
    // walk-local segment s starts at walk position s kSeg: checkpoint j
    // (reversed, a segment past L - 1 is entered at L - 1 with the state
    // its checkpoint holds; one wholly past L walks identities from zero)
    for (int i = threadIdx.x; i < kSegs * NT * kBwdChan; i += kBwdThreads) {
      const int s = i / (NT * kBwdChan), n = (i / kBwdChan) % NT;
      const int e = e0 + i % kBwdChan;
      const int j = phys(c, s * kSeg, rev) / kSeg;
      hk[i] = n < ns && e < dg && j < n_ck
                  ? v.hck[((size_t)j * N + s0 + n) * dg + e]
                  : 0.f;
    }
    __syncthreads();

    for (int n0 = 0; n0 < ns; n0 += kBwdIlp) {
      float accB[kBwdIlp][kItems], accC[kBwdIlp][kItems];
#pragma unroll
      for (int q = 0; q < kBwdIlp; ++q)
#pragma unroll
        for (int j = 0; j < kItems; ++j) accB[q][j] = accC[q][j] = 0.f;
      float dAq[kBwdPer * kBwdIlp];  // token-major: the group's dA terms
#pragma unroll
      for (int k = 0; k < kBwdPer * kBwdIlp; ++k) dAq[k] = 0.f;
#pragma unroll
      for (int i = 0; i < kBwdPer; ++i) {
        const int ch = warp + kBwdWarps * i, e = e0 + ch;
        if (e >= dg) break;
        float dk[kItems], uk[kItems], yk[kItems];
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          if constexpr (kTm) {
            dk[j] = dr[i][j];
            uk[j] = ur[i][j];
            yk[j] = yr[i][j];
          } else {
            const int r = slot(lane * kItems + j) * kBwdLdC + ch;
            dk[j] = ds[r];
            uk[j] = us[r];
            yk[j] = ys[r];
          }
        }
        float sbg[kItems], sag[kItems];  // token-major: this group's sums
#pragma unroll
        for (int j = 0; j < kItems; ++j) sbg[j] = sag[j] = 0.f;
        // per state: the lane's forward map (h) and adjoint map, composed
        // over the segment's lanes and over the chunk's lanes
        float ak[kBwdIlp][kItems], fa[kBwdIlp], fb[kBwdIlp], ga[kBwdIlp],
            gb[kBwdIlp];
#pragma unroll
        for (int q = 0; q < kBwdIlp; ++q) {
          const int n = n0 + q;
          const float an = as[n * kBwdChan + ch];
          fa[q] = ga[q] = 1.f;
          fb[q] = gb[q] = 0.f;
#pragma unroll
          for (int j = 0; j < kItems; ++j) {
            const int r = slot(lane * kItems + j) * kLdN + n;
            ak[q][j] = __expf(dk[j] * an);
            fb[q] = fmaf(ak[q][j], fb[q], dk[j] * uk[j] * bs[r]);
            fa[q] *= ak[q][j];
          }
#pragma unroll
          for (int j = kItems - 1; j >= 0; --j) {
            const int r = slot(lane * kItems + j) * kLdN + n;
            gb[q] = ak[q][j] * (gb[q] + cs[r] * yk[j]);
            ga[q] *= ak[q][j];
          }
        }
        scan_up<kBwdIlp, kSegLanes>(fa, fb, lane);
        scan_down<kBwdIlp>(ga, gb, lane);
#pragma unroll
        for (int q = 0; q < kBwdIlp; ++q) {
          const int n = n0 + q;
          const float an = as[n * kBwdChan + ch];
          // h entering the lane's run: the segment's checkpoint through the
          // segment's earlier lanes, i.e. the state leaving the lane below
          // (+ 0.f: the identity map's fmaf(1, h, 0), to the bit)
          const float hk_n = hk[(seg * NT + n) * kBwdChan + ch];
          float h = __shfl_up_sync(kFull, fmaf(fa[q], hk_n, fb[q]), 1,
                                   kSegLanes);
          if (lane % kSegLanes == 0) h = hk_n + 0.f;
          float hp[kItems];  // h before each walk position
#pragma unroll
          for (int j = 0; j < kItems; ++j) {
            const int r = slot(lane * kItems + j) * kLdN + n;
            hp[j] = h;
            h = fmaf(ak[q][j], h, dk[j] * uk[j] * bs[r]);
            accC[q][j] = fmaf(h, yk[j], accC[q][j]);
          }
          // the adjoint arriving from the lane above: the chunk's exit
          // adjoint through the later lanes, i.e. the adjoint leaving the
          // lane above
          const float lam_n = ls[n * kBwdChan + ch];
          float dh = __shfl_down_sync(kFull, fmaf(ga[q], lam_n, gb[q]), 1);
          if (lane == 31) dh = lam_n + 0.f;
          float dA_l = 0.f;
#pragma unroll
          for (int j = kItems - 1; j >= 0; --j) {
            const int r = slot(lane * kItems + j) * kLdN + n;
            dh += cs[r] * yk[j];
            const float dah = dh * ak[q][j] * hp[j];
            if constexpr (kTm) {
              sbg[j] = fmaf(dh, bs[r], sbg[j]);
              sag[j] = fmaf(dah, an, sag[j]);
            } else {
              sb[i][j] = fmaf(dh, bs[r], sb[i][j]);
              sa[i][j] = fmaf(dah, an, sa[i][j]);
            }
            dA_l = fmaf(dah, dk[j], dA_l);
            accB[q][j] = fmaf(dh, dk[j] * uk[j], accB[q][j]);
            dh *= ak[q][j];
          }
          if constexpr (kTm) {
            dAq[i * kBwdIlp + q] = dA_l;
          } else {
            dA_l = warp_sum(dA_l);
            if (lane == 0 && n < ns)
              p.dA[((bg * p.n_chunk + c) * N + s0 + n) * dg + e] = dA_l;
          }
        }
        if constexpr (kTm) {
#pragma unroll
          for (int j = 0; j < kItems; ++j) {
            sum_at(0, i, j) += sbg[j];
            sum_at(1, i, j) += sag[j];
          }
        }
      }
      if constexpr (kTm) {
        // the group's kBwdPer x kBwdIlp dA sums over the lanes at once:
        // lane l ends with term k = l / 4, of channel i = k / kBwdIlp and
        // state n0 + k % kBwdIlp
        sum_scatter<kBwdPer * kBwdIlp>(dAq, lane);
        const int k = lane / (32 / (kBwdPer * kBwdIlp));
        const int e = e0 + warp + kBwdWarps * (k / kBwdIlp);
        const int n = n0 + k % kBwdIlp;
        if (lane % (32 / (kBwdPer * kBwdIlp)) == 0 && e < dg && n < ns)
          p.dA[((bg * p.n_chunk + c) * N + s0 + n) * dg + e] = dAq[0];
      }
      // the group's dB / dC over the block's channels: each warp's sum over
      // its channels, then the warps in order, into the group's columns of
      // bs / cs (read by every warp above, before the barrier)
#pragma unroll
      for (int q = 0; q < kBwdIlp; ++q)
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          part[((warp * 2 + 0) * kBwdIlp + q) * kChunk + j * 32 + lane] =
              accB[q][j];
          part[((warp * 2 + 1) * kBwdIlp + q) * kChunk + j * 32 + lane] =
              accC[q][j];
        }
      __syncthreads();
      for (int i = threadIdx.x; i < 2 * kBwdIlp * kChunk; i += kBwdThreads) {
        const int which = i / (kBwdIlp * kChunk), q = (i / kChunk) % kBwdIlp;
        const int jl = i % kChunk;  // item j = jl / 32 of lane jl % 32
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kBwdWarps; ++w)
          s += part[((w * 2 + which) * kBwdIlp + q) * kChunk + jl];
        const int k = (jl % 32) * kItems + jl / 32;
        (which ? cs : bs)[slot(k) * kLdN + n0 + q] = s;
      }
      __syncthreads();
    }
    // the tile's dB / dC partials of this channel block (token-major: a run
    // of the chunk's tokens per state)
    for (int i = threadIdx.x; i < kChunk * ns; i += kBwdThreads) {
      const int k = kTm ? i % kChunk : i / ns, n = kTm ? i / kChunk : i % ns;
      const int t = phys(c, k, rev);
      if (t >= L) continue;
      const int r = slot(k) * kLdN + n;
      v.put_dbc(blk, t, s0 + n, bs[r], cs[r]);
    }
  }

  // du, dd per walk position (into us / ds, the warp's own columns, or
  // token-major straight out of the registers); the per-chunk dbias and dD
#pragma unroll
  for (int i = 0; i < kBwdPer; ++i) {
    const int ch = warp + kBwdWarps * i, e = e0 + ch;
    if (e >= dg) break;
    const float d_e = p.Dk ? p.Dk[(size_t)g * dg + e] : 0.f;
    float dbias_l = 0.f, dD_l = 0.f, du_k[kItems], dd_k[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int k = lane * kItems + j, r = slot(k) * kBwdLdC + ch;
      const float dv = kTm ? dr[i][j] : ds[r];
      const float uv = kTm ? ur[i][j] : us[r];
      const float yv = kTm ? yr[i][j] : ys[r];
      const float sbv = kTm ? sum_at(0, i, j) : sb[i][j];
      const float sav = kTm ? sum_at(1, i, j) : sa[i][j];
      float ddv = fmaf(uv, sbv, sav);
      // d = softplus(pre): sigmoid(pre) = 1 - e^-d, exact for small d
      if (p.softplus) ddv *= -expm1f(-dv);
      if (phys(c, k, rev) >= L) ddv = 0.f;
      du_k[j] = fmaf(dv, sbv, d_e * yv);
      dd_k[j] = ddv;
      if constexpr (!kTm) {
        us[r] = du_k[j];
        ds[r] = ddv;
      }
      dbias_l += ddv;
      dD_l = fmaf(yv, uv, dD_l);
    }
    if constexpr (kTm) {
      const int t0 = run_start(c, lane, rev);
      store_run(v.du_run(e), t0, L, v.vec, rev, du_k);
      store_run(v.dd_run(e), t0, L, v.vec, rev, dd_k);
    }
    if (p.dbias) {
      dbias_l = warp_sum(dbias_l);
      if (lane == 0) p.dbias[(bg * p.n_chunk + c) * dg + e] = dbias_l;
    }
    if (p.dD) {
      dD_l = warp_sum(dD_l);
      if (lane == 0) p.dD[(bg * p.n_chunk + c) * dg + e] = dD_l;
    }
  }
  if constexpr (!kTm) {
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * kBwdChan; i += kBwdThreads) {
      const int k = i / kBwdChan, ch = i % kBwdChan, e = e0 + ch;
      const int t = phys(c, k, rev);
      if (t >= L || e >= dg) continue;
      const int r = slot(k) * kBwdLdC + ch;
      v.put_du(t, e, us[r]);
      v.put_dd(t, e, ds[r]);
    }
  }
}

// The local adjoints, the carries, the emission over `chains` = batch * G
// chain instances (at most 65,535). TILED for N > NT.
template <class S, int NT, bool TILED>
int launch_chunk_bwd(const S& p, int chains, cudaStream_t stream) {
  constexpr int kLdN = NT + 1;
  constexpr size_t kStaged = S::kTokenMajor ? 0 : kRows * kBwdLdC;
  const size_t smem_local =
      sizeof(float) * (2 * kStaged + kRows * kLdN + NT * kBwdChan);
  constexpr size_t kSums =
      S::kTokenMajor ? 2 * kBwdPer * kItems * kBwdThreads : 0;
  const size_t smem_emit =
      sizeof(float) * (3 * kStaged + 2 * kRows * kLdN +
                       (2 + kSegs) * NT * kBwdChan +
                       kBwdWarps * 2 * kBwdIlp * kChunk + kSums);
  auto local = adjoint_local_kernel<S, NT, TILED>;
  auto emit = adjoint_emit_kernel<S, NT, TILED>;
  cudaError_t err = cudaFuncSetAttribute(
      local, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_local));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(emit,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_emit));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.n_chunk, (p.dg + kBwdChan - 1) / kBwdChan, chains);
  local<<<grid, kBwdThreads, smem_local, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t threads = (size_t)chains * p.N * p.dg;
  adjoint_carry_kernel<S>
      <<<(threads + 255) / 256, 256, 0, stream>>>(p, chains);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  emit<<<grid, kBwdThreads, smem_emit, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chunk
