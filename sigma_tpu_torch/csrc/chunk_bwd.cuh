// The chunk-parallel scan backward shared by K3 and K4 (csrc/scan_g_bwd.cu)
// and K11 (csrc/scan_img.cu). The forward is csrc/chunk_fwd.cuh's; per
// chain g, channel e, state n:
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
// token, staged through shared memory in walk order (slot).
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
//     float u_at(t, e), dy_at(t, e), dt_at(t, e) (raw, before the bias),
//     b_at(t, n), c_at(t, n) (n < N); void put_du(t, e, v), put_dd(t, e,
//     v); void put_dbc(blk, t, n, dB, dC) stores channel block blk's
//     partials; const float* hck, the chain's (n_ck, N, dg) checkpoints.
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

// What every source carries. Scratch lam (chains, n_chunk, N, dg), sd
// (chains, n_chunk, dg); the per-chunk partials dA (chains, n_chunk, N,
// dg), dbias and dD (chains, n_chunk, dg); chains = batch * G.
struct BwdArgs {
  const float* A;     // (G, N, dg)
  const float* bias;  // (G, dg)
  const float* Dk;    // (G, dg)
  float* lam;
  float* sd;
  float* dA;
  float* dbias;
  float* dD;
  int G, L, dg, N, softplus, n_chunk;
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
      dv = v.dt_at(t, e) + p.bias[(size_t)g * dg + e];
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

// the tile's C (and with FULL, B) of states [s0, s0 + ns) in walk order,
// zero past ns and past L
template <class S, int NT, bool FULL>
__device__ __forceinline__ void stage_states(const typename S::View& v, int c,
                                             int s0, int ns, int rev, int L,
                                             float* bs, float* cs) {
  constexpr int kLdN = NT + 1;
  for (int i = threadIdx.x; i < kChunk * NT; i += kBwdThreads) {
    const int k = i / NT, n = i % NT;
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
template <class S, int NT, bool TILED>
__global__ void __launch_bounds__(kBwdThreads)
adjoint_local_kernel(const S p) {
  extern __shared__ float smem[];
  constexpr int kLdN = NT + 1;
  float* ds = smem;                  // kRows x kBwdLdC: d
  float* ys = ds + kRows * kBwdLdC;  // kRows x kBwdLdC: dy
  float* cs = ys + kRows * kBwdLdC;  // kRows x kLdN: C
  float* ls = cs + kRows * kLdN;     // NT x kBwdChan: the chunk's adjoints
  const int c = blockIdx.x, e0 = blockIdx.y * kBwdChan;
  const int g = blockIdx.z % p.G, b = blockIdx.z / p.G;
  const int dg = p.dg, N = p.N;
  const int rev = p.rev(g);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t bg = (size_t)b * p.G + g;
  const size_t slab = (bg * p.n_chunk + c) * N * dg;
  const auto v = p.view(b, g);
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
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int r = slot(lane * kItems + j) * kBwdLdC + ch;
        dk[j] = ds[r];
        yk[j] = ys[r];
        dsum += dk[j];
      }
      for (int n0 = 0; n0 < ns; n0 += kBwdIlp) {
        float fa[kBwdIlp], fb[kBwdIlp];
#pragma unroll
        for (int q = 0; q < kBwdIlp; ++q) {
          const int n = n0 + q;
          const float an =
              n < ns ? p.A[((size_t)g * N + s0 + n) * dg + e] : 0.f;
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
  const float an = p.A[((size_t)g * N + n) * dg + e];
  walk_carries(p.lam + (bg * p.n_chunk * N + n) * dg + e,
               p.sd + bg * p.n_chunk * dg + e, (size_t)N * dg, dg, an,
               p.n_chunk, !p.rev(g));
}

// Pass 3: every output of chunk c from its exit adjoint (lam) and the
// checkpoints. Warp w takes channels w, w + 8, w + 16, w + 24; the states
// go in groups of kBwdIlp, each group's dB / dC channel sums reduced
// across the warps before the next group starts.
template <class S, int NT, bool TILED>
__global__ void __launch_bounds__(kBwdThreads, 2)
adjoint_emit_kernel(const S p) {
  extern __shared__ float smem[];
  constexpr int kLdN = NT + 1;
  float* us = smem;                    // kRows x kBwdLdC: u, then du
  float* ds = us + kRows * kBwdLdC;    // kRows x kBwdLdC: d, then dd
  float* ys = ds + kRows * kBwdLdC;    // kRows x kBwdLdC: dy
  float* bs = ys + kRows * kBwdLdC;    // kRows x kLdN: B, then dB
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
  stage_channels<S, true>(p, v, c, e0, g, rev, us, ds, ys);

  float sb[kBwdPer][kItems], sa[kBwdPer][kItems];  // sum_n dh B, dh A a h
#pragma unroll
  for (int i = 0; i < kBwdPer; ++i)
#pragma unroll
    for (int j = 0; j < kItems; ++j) sb[i][j] = sa[i][j] = 0.f;
  const int seg = lane / kSegLanes;
  for (int s0 = 0; s0 < (TILED ? N : 1); s0 += NT) {
    const int ns = TILED ? min(NT, N - s0) : N;  // states of this tile
    if (TILED && s0 > 0) __syncthreads();  // the last tile is written out
    stage_states<S, NT, true>(v, c, s0, ns, rev, L, bs, cs);
    for (int i = threadIdx.x; i < NT * kBwdChan; i += kBwdThreads) {
      const int n = i / kBwdChan, e = e0 + i % kBwdChan;
      const bool ok = n < ns && e < dg;
      ls[i] = ok ? p.lam[slab + (size_t)(s0 + n) * dg + e] : 0.f;
      as[i] = ok ? p.A[((size_t)g * N + s0 + n) * dg + e] : 0.f;
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
#pragma unroll
      for (int i = 0; i < kBwdPer; ++i) {
        const int ch = warp + kBwdWarps * i, e = e0 + ch;
        if (e >= dg) break;
        float dk[kItems], uk[kItems], yk[kItems];
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const int r = slot(lane * kItems + j) * kBwdLdC + ch;
          dk[j] = ds[r];
          uk[j] = us[r];
          yk[j] = ys[r];
        }
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
          // segment's earlier lanes
          float xa = __shfl_up_sync(kFull, fa[q], 1, kSegLanes);
          float xb = __shfl_up_sync(kFull, fb[q], 1, kSegLanes);
          if (lane % kSegLanes == 0) {
            xa = 1.f;
            xb = 0.f;
          }
          float h = fmaf(xa, hk[(seg * NT + n) * kBwdChan + ch], xb);
          float hp[kItems];  // h before each walk position
#pragma unroll
          for (int j = 0; j < kItems; ++j) {
            const int r = slot(lane * kItems + j) * kLdN + n;
            hp[j] = h;
            h = fmaf(ak[q][j], h, dk[j] * uk[j] * bs[r]);
            accC[q][j] = fmaf(h, yk[j], accC[q][j]);
          }
          // the adjoint arriving from the lane above: the chunk's exit
          // adjoint through the later lanes
          float za = __shfl_down_sync(kFull, ga[q], 1);
          float zb = __shfl_down_sync(kFull, gb[q], 1);
          if (lane == 31) {
            za = 1.f;
            zb = 0.f;
          }
          float dh = fmaf(za, ls[n * kBwdChan + ch], zb);
          float dA_l = 0.f;
#pragma unroll
          for (int j = kItems - 1; j >= 0; --j) {
            const int r = slot(lane * kItems + j) * kLdN + n;
            dh += cs[r] * yk[j];
            const float dah = dh * ak[q][j] * hp[j];
            sb[i][j] = fmaf(dh, bs[r], sb[i][j]);
            sa[i][j] = fmaf(dah, an, sa[i][j]);
            dA_l = fmaf(dah, dk[j], dA_l);
            accB[q][j] = fmaf(dh, dk[j] * uk[j], accB[q][j]);
            dh *= ak[q][j];
          }
          dA_l = warp_sum(dA_l);
          if (lane == 0 && n < ns)
            p.dA[((bg * p.n_chunk + c) * N + s0 + n) * dg + e] = dA_l;
        }
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
    // the tile's dB / dC partials of this channel block
    for (int i = threadIdx.x; i < kChunk * ns; i += kBwdThreads) {
      const int k = i / ns, n = i % ns;
      const int t = phys(c, k, rev);
      if (t >= L) continue;
      const int r = slot(k) * kLdN + n;
      v.put_dbc(blk, t, s0 + n, bs[r], cs[r]);
    }
  }

  // du, dd per walk position (into us / ds, the warp's own columns); the
  // per-chunk dbias and dD
#pragma unroll
  for (int i = 0; i < kBwdPer; ++i) {
    const int ch = warp + kBwdWarps * i, e = e0 + ch;
    if (e >= dg) break;
    const float d_e = p.Dk[(size_t)g * dg + e];
    float dbias_l = 0.f, dD_l = 0.f;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int k = lane * kItems + j, r = slot(k) * kBwdLdC + ch;
      const float dv = ds[r], uv = us[r], yv = ys[r];
      float ddv = fmaf(uv, sb[i][j], sa[i][j]);
      // d = softplus(pre): sigmoid(pre) = 1 - e^-d, exact for small d
      if (p.softplus) ddv *= -expm1f(-dv);
      if (phys(c, k, rev) >= L) ddv = 0.f;
      us[r] = fmaf(dv, sb[i][j], d_e * yv);
      ds[r] = ddv;
      dbias_l += ddv;
      dD_l = fmaf(yv, uv, dD_l);
    }
    dbias_l = warp_sum(dbias_l);
    dD_l = warp_sum(dD_l);
    if (lane == 0) {
      p.dbias[(bg * p.n_chunk + c) * dg + e] = dbias_l;
      p.dD[(bg * p.n_chunk + c) * dg + e] = dD_l;
    }
  }
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

// The local adjoints, the carries, the emission over `chains` = batch * G
// chain instances (at most 65,535). TILED for N > NT.
template <class S, int NT, bool TILED>
int launch_chunk_bwd(const S& p, int chains, cudaStream_t stream) {
  constexpr int kLdN = NT + 1;
  const size_t smem_local =
      sizeof(float) * (2 * kRows * kBwdLdC + kRows * kLdN + NT * kBwdChan);
  const size_t smem_emit =
      sizeof(float) * (3 * kRows * kBwdLdC + 2 * kRows * kLdN +
                       (2 + kSegs) * NT * kBwdChan +
                       kBwdWarps * 2 * kBwdIlp * kChunk);
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
