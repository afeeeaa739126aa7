// Backward selective-scan kernels for Hopper (sm_90a), fp32, plain C
// interface for ctypes. Built by sigma_tpu_torch/ops/_build.py with nvcc.
//
// Replace sigma_tpu/ops/pallas_scan_g.py::_bwd_kernel (:305), reached
// through _bwd_call (:989: the streamed pallas_call :1111 and the
// fused-projection one :1060) and _bwd_call_ml (:1140, pallas_call :1225).
// The forward is csrc/scan_g_fwd.cu's; per chain g, channel e, state n:
//     d_t = softplus(dt_t + bias_e)        a_t = exp(d_t A_ne)
//     h_t = a_t h_{t-1} + d_t u_t B_tn     y_t = sum_n C_tn h_t + D_e u_t
// and given dy, with dh_t the cotangent of h_t (dh_t = C_t dy_t +
// a_{t+1} dh_{t+1}), walked against the forward's order:
//     du_t  = d_t sum_n dh_t B_tn + D_e dy_t
//     dd_t  = (sum_n dh_t A a_t h_{t-1} + u_t sum_n dh_t B_tn) sigmoid(.)
//     dA   += dh_t a_t h_{t-1} d_t          dB_tn = sum_e dh_t d_t u_t
//     dC_tn = sum_e h_t dy_t                dD += dy_t u_t, dbias += dd_t
// A is the true A (the TPU kernel's A*log2e and ln2 factors are not
// carried over).
//
// K3 (streamed: dt, B, C read from device memory) and K4 (fused
// projection) share one chunk-parallel body, templated on PROJ so that a
// trace tells their launches apart. Three launches (K4: four), counted as
// one call by the wrappers:
//   K4a bwd_proj_kernel — K4 only: [dt | B | C] = u [W_dt | W_B | W_C]
//     once per chain on the tensor cores into an fp32 scratch stream P
//     (batch, G, L, dg + 2N), with K2a's tiles (tc::proj_tile: 3xTF32), so
//     the streams K4 scans back are the bits K2 scanned and checkpointed.
//     From here on K4 is K3 reading dt / B / C out of P (under swap_c,
//     C from the partner chain's P).
//   adjoint_local_kernel — the sequence is cut into chunks of kChunk = 128
//     physical tokens, aligned with the 32-token checkpoint segments (the
//     last chunk ragged; tokens past L walk as identities, d = 0). One
//     block per (chunk, 32 channels, chain) stages the chunk in walk order
//     and, per channel and state, folds each lane's 4 walk positions of
//     the adjoint map x -> a_t (C_t dy_t + x) and composes the 32 lanes
//     against the walk (chunk::scan_down): the chunk's adjoint leaving its
//     first token from a zero adjoint at its exit (lam), and its sum of d
//     (sd: the adjoint decays across the chunk by exp(A_ne sum_t d_t)).
//   adjoint_carry_kernel — one thread per (batch, chain, state, channel)
//     walks the chunks against the walk (chunk::walk_carries, K2c's
//     carry in the other direction) and leaves in lam the adjoint entering
//     each chunk at its exit: a fixed order, no atomics.
//   adjoint_emit_kernel — per (chunk, 32 channels, chain) again. h needs
//     no carry: hck holds h as the walk enters every 32-token segment, so
//     h is recomputed inside each segment (8 lanes, chunk::scan_up over
//     8-lane groups). The adjoint is re-swept from the true exit adjoint
//     (chunk::scan_down) and every output formed per token: du (the
//     direct term; K5 adds the chain term), dd; dA, dbias, dD as
//     per-chunk partials; dB, dC summed over the block's channels (each
//     warp over its 4 channels in registers, then the 8 warps in order in
//     shared memory) into per-block partials (batch, nblk, G, L, N), dC
//     routed to the chain whose projection made the C. The wrapper sums
//     the partials over chunks, channel blocks and batch in a fixed order,
//     so a rerun gives the same bits for all seven gradients.
//   Bound: device memory and the fp32 cores about evenly. Per token and
//   channel ~40 bytes of device traffic (u, dt, dy read, du, dd written,
//   the checkpoints), against ~22 flops and two exps per token, channel
//   and state (the local pass and the re-sweep); at d_state 16 the two
//   bounds lie within 10% of each other. K4 adds its projections,
//   2 dg (dg + 2N) flops per token and chain on the TF32 tensor cores.
//   Design: work spreads over (chunk, channel tile, chain, batch): 3,600
//   blocks at the train step's ConMB stage 0 (L 38,400, dg 192) where the
//   sequential design this replaces had 12. Every global access is a row
//   of 32 channels (or N states) of one token, staged through shared
//   memory in walk order (chunk::slot).
//
// K5 weight_grad_kernel + du_chain_kernel (one entry point) — the products
//   the TPU kernel runs in its own body (:594-622): per chain
//   [dW_dt | dW_B | dW_C] = u^T [dd | dB | dC], and
//   du += [dd | dB | dC] [W_dt | W_B | W_C]^T.
//   Bound: 4 dg (dg + 2N) flops per token and chain on the tensor cores
//   (TF32), against ~16 dg bytes per token (u and dd read, du read and
//   written): device memory at these shapes.
//   Design (csrc/tc_gemm.cuh): 64 x 64 output tiles on the tensor cores,
//   mma.sync m16n8k8 on 1xTF32 operands with fp32 accumulation, k-tiles
//   of 32 copied by cp.async into two shared buffers, one tile ahead of
//   the MMAs, 16-byte copies along each operand's contiguous axis. [dB | dC] and [W_B | W_C]
//   arrive concatenated (the wrapper's copies, 2N columns), so the three
//   parts are two operands chosen per tile or per k-tile, never per
//   element. The weight gradient contracts over all batch * L tokens: each
//   block takes one batch element's split of whole k-tiles, and the
//   partials (n_l * batch, G, dg, dg + 2N) are summed by the caller in a
//   fixed order, so a rerun gives the same bits; each du element is owned
//   by one block. Number format: 3xTF32 (fp32's accuracy) runs three
//   MMAs per product and lost to cuBLAS's fp32 products at the ConMB
//   shapes on the H100; 1xTF32 keeps the weight gradient within about 3e-4
//   of max(|ref|, 1) over 76,800 tokens (tests/test_torch_port_tf32.py), a
//   seventh of the fp32 tier's 2e-3.

// All launch on the caller's stream, allocate nothing, and return
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

#include "chunk.cuh"
#include "tc_gemm.cuh"

namespace {

using namespace chunk;  // kSeg, kItems, kChunk, kRows, phys, slot, scans

constexpr int kChan = 32;        // channels per block
constexpr int kThreads = 256;    // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kPer = kChan / kWarps;  // channels per warp: warp, warp + 8, ..
constexpr int kIlp = 2;          // states scanned together
constexpr int kLdC = kChan + 1;  // row pitch of the staged channel rows
constexpr int kSegs = kChunk / kSeg;         // checkpoint segments a chunk
constexpr int kSegLanes = kSeg / kItems;     // lanes a segment
static_assert(4 % kIlp == 0, "the state widths (4, 8, 16) hold whole groups");

constexpr int kErrStateWidth = 10001;
constexpr int kErrArguments = 10003;

struct BwdArgs {
  // u / dy / du: n_u == 2: two layouts (batch, L, dg), chain g on layout g;
  // n_u == 1: (batch, G, L, dg) in slot 0
  const float* u[2];
  const float* dy[2];
  float* du[2];
  // the dt / B / C streams: chain (b, g)'s token t at
  // dt[(b G + g) sdt + t ldt], B / C[(b G + g) sbc + t ldbc] (C of the
  // chain whose projection made it); K3: (batch, G, L, dg) and (batch, G,
  // L, N); K4: columns 0, dg and dg + N of P
  const float* dt;
  const float* Bm;
  const float* Cm;
  size_t sdt, sbc;
  int ldt, ldbc;
  const float* A;     // (G, N, dg)
  const float* bias;  // (G, dg)
  const float* Dk;    // (G, dg)
  const float* hck;   // (batch, G, nck, N, dg)
  float* lam;         // (batch, G, n_chunk, N, dg) scratch: chunk adjoints
  float* sd;          // (batch, G, n_chunk, dg) scratch: sum of d per chunk
  float* dd;          // (batch, G, L, dg) raw-dt cotangent
  float* dA;          // (batch, G, n_chunk, N, dg) per-chunk partials
  float* dbias;       // (batch, G, n_chunk, dg) per-chunk partials
  float* dD;          // (batch, G, n_chunk, dg) per-chunk partials
  float* dBp;         // (batch, nblk, G, L, N) per-block partials
  float* dCp;         // the same; swap_c routes to the projecting chain
  int G, L, dg, N, n_u, softplus, reverse, swap_c, nck, nblk, n_chunk;
};

__device__ __forceinline__ size_t chain_offset(const BwdArgs& p, int b,
                                               int g) {
  return p.n_u == 2 ? (size_t)b * p.L * p.dg
                    : ((size_t)b * p.G + g) * p.L * p.dg;
}

// K4a: P[b, g] = u[b, g] [W_dt | W_B | W_C][g], as K2a
__global__ void __launch_bounds__(tc::kGemmThreads)
bwd_proj_kernel(const BwdArgs p, const float* wdt, const float* wbc,
                float* P) {
  const int g = blockIdx.z % p.G, b = blockIdx.z / p.G;
  const int dg = p.dg, N = p.N;
  tc::proj_tile<float>(p.u[p.n_u == 2 ? g : 0] + chain_offset(p, b, g),
                       wdt + (size_t)g * dg * dg, wbc + (size_t)g * dg * 2 * N,
                       P + ((size_t)b * p.G + g) * p.L * (dg + 2 * N), p.L,
                       dg, N, blockIdx.x * tc::kBM, blockIdx.y);
}

// Stage chunk c of chain (b, g) in walk order: ds d = softplus(dt + bias)
// (or dt + bias), ys dy, cs C, and with FULL us u and bs B. Tokens past L
// and channels past dg stage as zeros (d = 0: an identity step).
template <int NT, bool FULL>
__device__ __forceinline__ void stage(const BwdArgs& p, int c, int e0, int b,
                                      int g, float* us, float* ds, float* ys,
                                      float* bs, float* cs) {
  constexpr int kLdN = NT + 1;
  const int dg = p.dg, N = p.N, L = p.L;
  const size_t bg = (size_t)b * p.G + g;
  const int gp = p.swap_c ? (g ^ 1) : g;
  const float* u_c = p.u[p.n_u == 2 ? g : 0] + chain_offset(p, b, g);
  const float* dy_c = p.dy[p.n_u == 2 ? g : 0] + chain_offset(p, b, g);
  const float* dt_c = p.dt + bg * p.sdt;
  const float* B_c = p.Bm + bg * p.sbc;
  const float* C_c = p.Cm + ((size_t)b * p.G + gp) * p.sbc;
  for (int i = threadIdx.x; i < kChunk * kChan; i += kThreads) {
    const int k = i / kChan, ch = i % kChan, e = e0 + ch;
    const int t = phys(c, k, p.reverse);
    float uv = 0.f, dv = 0.f, yv = 0.f;
    if (t < L && e < dg) {
      dv = dt_c[(size_t)t * p.ldt + e] + p.bias[(size_t)g * dg + e];
      if (p.softplus) dv = softplus_f(dv);
      yv = dy_c[(size_t)t * dg + e];
      if (FULL) uv = u_c[(size_t)t * dg + e];
    }
    const int r = slot(k) * kLdC + ch;
    ds[r] = dv;
    ys[r] = yv;
    if (FULL) us[r] = uv;
  }
  for (int i = threadIdx.x; i < kChunk * NT; i += kThreads) {
    const int k = i / NT, n = i % NT;
    const int t = phys(c, k, p.reverse);
    const bool ok = t < L && n < N;
    const int r = slot(k) * kLdN + n;
    cs[r] = ok ? C_c[(size_t)t * p.ldbc + n] : 0.f;
    if (FULL) bs[r] = ok ? B_c[(size_t)t * p.ldbc + n] : 0.f;
  }
}

// the sum over a warp's 32 lanes, in a fixed order
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Pass 1: per (chunk, 32 channels, chain), the adjoint leaving the chunk's
// first walk position from a zero adjoint at its exit (lam) and the
// chunk's sum of d per channel (sd). Lane l holds walk positions 4l..4l+3;
// its map x -> a_{4l} (c_{4l} + a_{4l+1} (c_{4l+1} + ...)), c_t = C_t dy_t,
// x the adjoint arriving from lane l + 1, composes lane 31 first.
template <int NT, bool PROJ>
__global__ void __launch_bounds__(kThreads)
adjoint_local_kernel(const BwdArgs p) {
  extern __shared__ float smem[];
  constexpr int kLdN = NT + 1;
  float* ds = smem;               // kRows x kLdC: d
  float* ys = ds + kRows * kLdC;  // kRows x kLdC: dy
  float* cs = ys + kRows * kLdC;  // kRows x kLdN: C
  float* ls = cs + kRows * kLdN;  // NT x kChan: the chunk's adjoints
  const int c = blockIdx.x, e0 = blockIdx.y * kChan;
  const int g = blockIdx.z % p.G, b = blockIdx.z / p.G;
  const int dg = p.dg, N = p.N;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t bg = (size_t)b * p.G + g;
  stage<NT, false>(p, c, e0, b, g, nullptr, ds, ys, nullptr, cs);
  __syncthreads();

  for (int ch = warp; ch < kChan; ch += kWarps) {
    const int e = e0 + ch;
    if (e >= dg) break;
    float dk[kItems], yk[kItems];
    float dsum = 0.f;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int r = slot(lane * kItems + j) * kLdC + ch;
      dk[j] = ds[r];
      yk[j] = ys[r];
      dsum += dk[j];
    }
    for (int n0 = 0; n0 < N; n0 += kIlp) {
      float fa[kIlp], fb[kIlp];
#pragma unroll
      for (int q = 0; q < kIlp; ++q) {
        const int n = n0 + q;
        const float an = n < N ? p.A[((size_t)g * N + n) * dg + e] : 0.f;
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
      scan_down<kIlp>(fa, fb, lane);
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < kIlp; ++q) ls[(n0 + q) * kChan + ch] = fb[q];
      }
    }
    dsum = warp_sum(dsum);
    if (lane == 0) p.sd[(bg * p.n_chunk + c) * dg + e] = dsum;
  }
  __syncthreads();
  const size_t slab = (bg * p.n_chunk + c) * N * dg;
  for (int i = threadIdx.x; i < N * kChan; i += kThreads) {
    const int n = i / kChan, e = e0 + i % kChan;
    if (e < dg) p.lam[slab + (size_t)n * dg + e] = ls[i];
  }
}

// Pass 2: lam[c] becomes the adjoint entering chunk c at its exit, the
// chunks walked against the walk (K2c's carry in the other direction).
// PROJ only names K4's launches apart from K3's.
template <bool PROJ>
__global__ void adjoint_carry_kernel(const BwdArgs p, int batch) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int dg = p.dg, N = p.N;
  if (i >= (size_t)batch * p.G * N * dg) return;
  const int e = i % dg, n = (i / dg) % N;
  const size_t bg = i / ((size_t)N * dg);
  const float an = p.A[((size_t)(bg % p.G) * N + n) * dg + e];
  walk_carries(p.lam + (bg * p.n_chunk * N + n) * dg + e,
               p.sd + bg * p.n_chunk * dg + e, (size_t)N * dg, dg, an,
               p.n_chunk, !p.reverse);
}

// Pass 3: every output of chunk c from its exit adjoint (lam) and the
// checkpoints. Warp w takes channels w, w + 8, w + 16, w + 24; the states
// go in groups of kIlp, each group's dB / dC channel sums reduced across
// the warps before the next group starts.
template <int NT, bool PROJ>
__global__ void __launch_bounds__(kThreads, 2)
adjoint_emit_kernel(const BwdArgs p) {
  extern __shared__ float smem[];
  constexpr int kLdN = NT + 1;
  float* us = smem;                    // kRows x kLdC: u, then du
  float* ds = us + kRows * kLdC;       // kRows x kLdC: d, then dd
  float* ys = ds + kRows * kLdC;       // kRows x kLdC: dy
  float* bs = ys + kRows * kLdC;       // kRows x kLdN: B, then dB
  float* cs = bs + kRows * kLdN;       // kRows x kLdN: C, then dC
  float* ls = cs + kRows * kLdN;       // NT x kChan: exit adjoints
  float* as = ls + NT * kChan;         // NT x kChan: A
  float* hk = as + NT * kChan;         // kSegs x NT x kChan: checkpoints
  float* part = hk + kSegs * NT * kChan;  // kWarps x 2 x kIlp x kChunk
  const int c = blockIdx.x, blk = blockIdx.y, e0 = blk * kChan;
  const int g = blockIdx.z % p.G, b = blockIdx.z / p.G;
  const int gp = p.swap_c ? (g ^ 1) : g;
  const int dg = p.dg, N = p.N, L = p.L;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t bg = (size_t)b * p.G + g;
  stage<NT, true>(p, c, e0, b, g, us, ds, ys, bs, cs);
  const size_t slab = (bg * p.n_chunk + c) * N * dg;
  for (int i = threadIdx.x; i < NT * kChan; i += kThreads) {
    const int n = i / kChan, e = e0 + i % kChan;
    const bool ok = n < N && e < dg;
    ls[i] = ok ? p.lam[slab + (size_t)n * dg + e] : 0.f;
    as[i] = ok ? p.A[((size_t)g * N + n) * dg + e] : 0.f;
  }
  // walk-local segment s starts at walk position s kSeg: checkpoint j
  // (reversed, a segment past L - 1 is entered at L - 1 with the state its
  // checkpoint holds; one wholly past L walks identities from zero)
  for (int i = threadIdx.x; i < kSegs * NT * kChan; i += kThreads) {
    const int s = i / (NT * kChan), n = (i / kChan) % NT;
    const int e = e0 + i % kChan;
    const int j = phys(c, s * kSeg, p.reverse) / kSeg;
    hk[i] = n < N && e < dg && j < p.nck
                ? p.hck[((bg * p.nck + j) * N + n) * dg + e]
                : 0.f;
  }
  __syncthreads();

  float sb[kPer][kItems], sa[kPer][kItems];  // sum_n dh B, sum_n dh A a h
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kItems; ++j) sb[i][j] = sa[i][j] = 0.f;
  const int seg = lane / kSegLanes;
  for (int n0 = 0; n0 < N; n0 += kIlp) {
    float accB[kIlp][kItems], accC[kIlp][kItems];
#pragma unroll
    for (int q = 0; q < kIlp; ++q)
#pragma unroll
      for (int j = 0; j < kItems; ++j) accB[q][j] = accC[q][j] = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int ch = warp + kWarps * i, e = e0 + ch;
      if (e >= dg) break;
      float dk[kItems], uk[kItems], yk[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int r = slot(lane * kItems + j) * kLdC + ch;
        dk[j] = ds[r];
        uk[j] = us[r];
        yk[j] = ys[r];
      }
      // per state: the lane's forward map (h) and adjoint map, composed
      // over the segment's lanes and over the chunk's lanes
      float ak[kIlp][kItems], fa[kIlp], fb[kIlp], ga[kIlp], gb[kIlp];
#pragma unroll
      for (int q = 0; q < kIlp; ++q) {
        const int n = n0 + q;
        const float an = as[n * kChan + ch];
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
      scan_up<kIlp, kSegLanes>(fa, fb, lane);
      scan_down<kIlp>(ga, gb, lane);
#pragma unroll
      for (int q = 0; q < kIlp; ++q) {
        const int n = n0 + q;
        const float an = as[n * kChan + ch];
        // h entering the lane's run: the segment's checkpoint through the
        // segment's earlier lanes
        float xa = __shfl_up_sync(kFull, fa[q], 1, kSegLanes);
        float xb = __shfl_up_sync(kFull, fb[q], 1, kSegLanes);
        if (lane % kSegLanes == 0) {
          xa = 1.f;
          xb = 0.f;
        }
        float h = fmaf(xa, hk[(seg * NT + n) * kChan + ch], xb);
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
        float dh = fmaf(za, ls[n * kChan + ch], zb);
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
        if (lane == 0 && n < N)
          p.dA[((bg * p.n_chunk + c) * N + n) * dg + e] = dA_l;
      }
    }
    // the group's dB / dC over the block's channels: each warp's sum over
    // its channels, then the warps in order, into the group's columns of
    // bs / cs (read by every warp above, before the barrier)
#pragma unroll
    for (int q = 0; q < kIlp; ++q)
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        part[((warp * 2 + 0) * kIlp + q) * kChunk + j * 32 + lane] =
            accB[q][j];
        part[((warp * 2 + 1) * kIlp + q) * kChunk + j * 32 + lane] =
            accC[q][j];
      }
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * kIlp * kChunk; i += kThreads) {
      const int which = i / (kIlp * kChunk), q = (i / kChunk) % kIlp;
      const int jl = i % kChunk;  // item j = jl / 32 of lane jl % 32
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        s += part[((w * 2 + which) * kIlp + q) * kChunk + jl];
      const int k = (jl % 32) * kItems + jl / 32;
      (which ? cs : bs)[slot(k) * kLdN + n0 + q] = s;
    }
    __syncthreads();
  }

  // du, dd per walk position (into us / ds, the warp's own columns); the
  // per-chunk dbias and dD
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int ch = warp + kWarps * i, e = e0 + ch;
    if (e >= dg) break;
    const float d_e = p.Dk[(size_t)g * dg + e];
    float dbias_l = 0.f, dD_l = 0.f;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int k = lane * kItems + j, r = slot(k) * kLdC + ch;
      const float dv = ds[r], uv = us[r], yv = ys[r];
      float ddv = fmaf(uv, sb[i][j], sa[i][j]);
      // d = softplus(pre): sigmoid(pre) = 1 - e^-d, exact for small d
      if (p.softplus) ddv *= -expm1f(-dv);
      if (phys(c, k, p.reverse) >= L) ddv = 0.f;
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

  float* du_c = p.du[p.n_u == 2 ? g : 0] + chain_offset(p, b, g);
  float* dd_c = p.dd + bg * L * dg;
  for (int i = threadIdx.x; i < kChunk * kChan; i += kThreads) {
    const int k = i / kChan, ch = i % kChan, e = e0 + ch;
    const int t = phys(c, k, p.reverse);
    if (t >= L || e >= dg) continue;
    const int r = slot(k) * kLdC + ch;
    du_c[(size_t)t * dg + e] = us[r];
    dd_c[(size_t)t * dg + e] = ds[r];
  }
  float* dB_c = p.dBp + (((size_t)b * p.nblk + blk) * p.G + g) * L * N;
  float* dC_c = p.dCp + (((size_t)b * p.nblk + blk) * p.G + gp) * L * N;
  for (int i = threadIdx.x; i < kChunk * N; i += kThreads) {
    const int k = i / N, n = i % N;
    const int t = phys(c, k, p.reverse);
    if (t >= L) continue;
    const int r = slot(k) * kLdN + n;
    dB_c[(size_t)t * N + n] = bs[r];
    dC_c[(size_t)t * N + n] = cs[r];
  }
}

template <int NT, bool PROJ>
int launch_chunks(const BwdArgs& p, int batch, cudaStream_t stream) {
  constexpr int kLdN = NT + 1;
  const size_t smem_local =
      sizeof(float) * (2 * kRows * kLdC + kRows * kLdN + NT * kChan);
  const size_t smem_emit =
      sizeof(float) * (3 * kRows * kLdC + 2 * kRows * kLdN +
                       (2 + kSegs) * NT * kChan +
                       kWarps * 2 * kIlp * kChunk);
  auto local = adjoint_local_kernel<NT, PROJ>;
  auto emit = adjoint_emit_kernel<NT, PROJ>;
  cudaError_t err = cudaFuncSetAttribute(
      local, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_local));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(emit,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_emit));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.n_chunk, p.nblk, batch * p.G);
  local<<<grid, kThreads, smem_local, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t threads = (size_t)batch * p.G * p.N * p.dg;
  adjoint_carry_kernel<PROJ>
      <<<(threads + 255) / 256, 256, 0, stream>>>(p, batch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  emit<<<grid, kThreads, smem_emit, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool PROJ>
int dispatch_bwd(const BwdArgs& p, int batch, cudaStream_t s) {
  if (p.N <= 4) return launch_chunks<4, PROJ>(p, batch, s);
  if (p.N <= 8) return launch_chunks<8, PROJ>(p, batch, s);
  if (p.N <= 16) return launch_chunks<16, PROJ>(p, batch, s);
  return kErrStateWidth;
}

// ---------------------------------------------------------------- K5
// 1xTF32 (csrc/tc_gemm.cuh): admitted by tests/test_torch_port_tf32.py,
// inside the fp32 gradient tier at the longest contraction
constexpr bool kSplitK5 = false;

struct GradArgs {
  const float* u[2];  // as BwdArgs
  float* du[2];
  const float* dd;    // (batch, G, L, dg)
  const float* dbc;   // (batch, G, L, 2N): [dB | dC], dC routed to its chain
  const float* wdt;   // (G, dg, dg)
  const float* wbc;   // (G, dg, 2N): [W_B | W_C]
  float* dW;          // (nsplit, G, dg, dg + 2N), nsplit = n_l * batch
  int batch, G, L, dg, N, n_u, n_l;
};

// chain g of batch b in u / du: n_u == 2 holds one layout per chain
__device__ __forceinline__ size_t u_base(int n_u, int G, int L, int dg, int b,
                                         int g) {
  return (n_u == 2 ? (size_t)b : (size_t)b * G + g) * L * dg;
}

// dW[s * batch + b, g, d, k] = sum over the tokens t of split s of
// u[b, g, t, d] Z[b, g, t, k], Z = [dd | dB | dC]: a 64 x 64 tile of
// (d, k) per block, k-tiles of 32 tokens; the tile's columns lie in dd
// (tiles below ceil(dg / 64)) or in [dB | dC] (the rest), decided once.
__global__ void __launch_bounds__(tc::kGemmThreads)
weight_grad_kernel(const GradArgs p) {
  using namespace tc;
  const int g = blockIdx.z % p.G;
  const int b = (blockIdx.z / p.G) % p.batch;
  const int s = blockIdx.z / (p.G * p.batch);
  const int dg = p.dg, m0 = blockIdx.x * kBM;
  const int ntd = (dg + kBN - 1) / kBN;
  const bool in_dd = blockIdx.y < ntd;
  const int n0 = (in_dd ? blockIdx.y : blockIdx.y - ntd) * kBN;
  const int nz = in_dd ? dg : 2 * p.N;  // columns of this tile's source
  const int col0 = in_dd ? 0 : dg;      // its first column in Z
  // split s of batch b: tokens [t0, t1), a whole number of k-tiles
  const int per = ((p.L + p.n_l - 1) / p.n_l + kBK - 1) / kBK * kBK;
  const int t0 = min(p.L, s * per), t1 = min(p.L, t0 + per);
  const size_t tok = ((size_t)b * p.G + g) * p.L;
  const float* ub =
      p.u[p.n_u == 2 ? g : 0] + u_base(p.n_u, p.G, p.L, dg, b, g);
  const float* zb = in_dd ? p.dd + tok * dg : p.dbc + tok * 2 * p.N;
  const bool vu = vec_ok(ub, dg), vz = vec_ok(zb, nz);
  float acc[2][4][4];
  gemm_loop_async<true, true, kSplitK5>(
      (t1 - t0 + kBK - 1) / kBK, dg - m0, nz - n0,
      [=](int kt, float* sa, float* sb) {
        k_tile_async(sa, ub, dg, t0 + kt * kBK, t1, m0, dg, vu);
        k_tile_async(sb, zb, nz, t0 + kt * kBK, t1, n0, nz, vz);
      },
      [=](int kt) { return t1 - t0 - kt * kBK; }, acc);
  const int kz = dg + 2 * p.N;
  float* out = p.dW + ((size_t)(s * p.batch + b) * p.G + g) * dg * kz;
  for_each_out(acc, [&](int r, int c, float v) {
    if (m0 + r < dg && n0 + c < nz)
      out[(size_t)(m0 + r) * kz + col0 + n0 + c] = v;
  });
}

// du[b, g, t, d] += sum_k Z[b, g, t, k] W[g, d, k]: a 64 x 64 tile of
// (t, d) per block, the column tiles of one row tile launched together
// (so the row tile's dd is read from L2 after the first); the k-tiles run
// over dd against W_dt, then over [dB | dC] against [W_B | W_C], each part
// masked at its own width.
__global__ void __launch_bounds__(tc::kGemmThreads)
du_chain_kernel(const GradArgs p) {
  using namespace tc;
  const int g = blockIdx.z % p.G, b = blockIdx.z / p.G;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int dg = p.dg, L = p.L, n2 = 2 * p.N;
  const size_t tok = ((size_t)b * p.G + g) * L;
  const float* zd = p.dd + tok * dg;
  const float* zbc = p.dbc + tok * n2;
  const float* wd = p.wdt + (size_t)g * dg * dg;
  const float* wbc = p.wbc + (size_t)g * dg * n2;
  const bool v1 = vec_ok(zd, dg) && vec_ok(wd, dg);
  const bool v2 = vec_ok(zbc, n2) && vec_ok(wbc, n2);
  const int nt1 = (dg + kBK - 1) / kBK, nt2 = (n2 + kBK - 1) / kBK;
  float acc[2][4][4];
  gemm_loop_async<false, false, kSplitK5>(
      nt1 + nt2, L - m0, dg - n0,
      [=](int kt, float* sa, float* sb) {
        if (kt < nt1) {
          row_tile_async(sa, zd, dg, m0, L, kt * kBK, dg, v1);
          row_tile_async(sb, wd, dg, n0, dg, kt * kBK, dg, v1);
        } else {
          row_tile_async(sa, zbc, n2, m0, L, (kt - nt1) * kBK, n2, v2);
          row_tile_async(sb, wbc, n2, n0, dg, (kt - nt1) * kBK, n2, v2);
        }
      },
      [=](int kt) { return kt < nt1 ? dg - kt * kBK : n2 - (kt - nt1) * kBK; },
      acc);
  float* du = p.du[p.n_u == 2 ? g : 0] + u_base(p.n_u, p.G, L, dg, b, g);
  for_each_out(acc, [&](int r, int c, float v) {
    if (m0 + r < L && n0 + c < dg)
      du[(size_t)(m0 + r) * dg + n0 + c] += v;
  });
}

bool bad_shape(int batch, int G, int L, int dg, int N, int n_u) {
  return batch <= 0 || G <= 0 || L <= 0 || dg <= 0 || N <= 0 ||
         G > 65535 || batch > 65535 || (n_u != 1 && n_u != 2) ||
         (n_u == 2 && G != 2);
}

// K3 / K4's own checks: the chains fit the grid, the checkpoints and the
// chunk scratch have the kernels' spacing
bool bad_chunks(int batch, int G, int L, int nck, int n_chunk) {
  return (size_t)batch * G > 65535 || nck != (L + kSeg - 1) / kSeg ||
         n_chunk != (L + kChunk - 1) / kChunk;
}

}  // namespace

extern "C" {

// K3. u, dt, dy, du, dd: (batch, G, L, dg); Bm, Cm: (batch, G, L, N);
// A: (G, N, dg); bias, Dk: (G, dg); hck: (batch, G, nck, N, dg) from K1;
// dA: (batch, G, n_chunk, N, dg); dbias, dD: (batch, G, n_chunk, dg);
// dBp, dCp: (batch, ceil(dg / 32), G, L, N); scratch lam (batch, G,
// n_chunk, N, dg), sd (batch, G, n_chunk, dg), n_chunk = ceil(L / 128).
// All fp32.
int sigma_scan_bwd(const float* u, const float* dt, const float* A,
                   const float* Bm, const float* Cm, const float* bias,
                   const float* Dk, const float* hck, const float* dy,
                   float* du, float* dd, float* dA, float* dbias, float* dD,
                   float* dBp, float* dCp, float* lam, float* sd,
                   int n_chunk, int batch, int G, int L, int dg, int N,
                   int nck, int softplus, int reverse, void* stream) {
  if (bad_shape(batch, G, L, dg, N, 1) ||
      bad_chunks(batch, G, L, nck, n_chunk))
    return kErrArguments;
  BwdArgs p = {};
  p.u[0] = u;
  p.dy[0] = dy;
  p.du[0] = du;
  p.dt = dt;
  p.Bm = Bm;
  p.Cm = Cm;
  p.sdt = (size_t)L * dg;
  p.sbc = (size_t)L * N;
  p.ldt = dg;
  p.ldbc = N;
  p.A = A;
  p.bias = bias;
  p.Dk = Dk;
  p.hck = hck;
  p.lam = lam;
  p.sd = sd;
  p.dd = dd;
  p.dA = dA;
  p.dbias = dbias;
  p.dD = dD;
  p.dBp = dBp;
  p.dCp = dCp;
  p.G = G;
  p.L = L;
  p.dg = dg;
  p.N = N;
  p.n_u = 1;
  p.softplus = softplus;
  p.reverse = reverse;
  p.nck = nck;
  p.nblk = (dg + kChan - 1) / kChan;
  p.n_chunk = n_chunk;
  return dispatch_bwd<false>(p, batch, static_cast<cudaStream_t>(stream));
}

// K4. n_u == 2: u0/u1, dy0/dy1, du0/du1 are the two layouts (batch, L, dg)
// and G == 2; n_u == 1: slot 0 is (batch, G, L, dg). wdt: (G, dg, dg);
// wbc: (G, dg, 2N), [W_B | W_C]; scratch P: (batch, G, L, dg + 2N); the
// rest as for sigma_scan_bwd, with dCp routed to the partner chain under
// swap_c (G even).
int sigma_scan_proj_bwd(const float* u0, const float* u1, const float* wdt,
                        const float* wbc, const float* A, const float* bias,
                        const float* Dk, const float* hck, const float* dy0,
                        const float* dy1, float* du0, float* du1, float* P,
                        float* dd, float* dA, float* dbias, float* dD,
                        float* dBp, float* dCp, float* lam, float* sd,
                        int n_chunk, int batch, int G, int L, int dg, int N,
                        int nck, int n_u, int softplus, int reverse,
                        int swap_c, void* stream) {
  if (bad_shape(batch, G, L, dg, N, n_u) || (swap_c && G % 2) ||
      bad_chunks(batch, G, L, nck, n_chunk))
    return kErrArguments;
  if (N > 16) return kErrStateWidth;
  const size_t kz = (size_t)dg + 2 * N;
  BwdArgs p = {};
  p.u[0] = u0;
  p.u[1] = u1;
  p.dy[0] = dy0;
  p.dy[1] = dy1;
  p.du[0] = du0;
  p.du[1] = du1;
  p.dt = P;
  p.Bm = P + dg;
  p.Cm = P + dg + N;
  p.sdt = p.sbc = (size_t)L * kz;
  p.ldt = p.ldbc = static_cast<int>(kz);
  p.A = A;
  p.bias = bias;
  p.Dk = Dk;
  p.hck = hck;
  p.lam = lam;
  p.sd = sd;
  p.dd = dd;
  p.dA = dA;
  p.dbias = dbias;
  p.dD = dD;
  p.dBp = dBp;
  p.dCp = dCp;
  p.G = G;
  p.L = L;
  p.dg = dg;
  p.N = N;
  p.n_u = n_u;
  p.softplus = softplus;
  p.reverse = reverse;
  p.swap_c = swap_c;
  p.nck = nck;
  p.nblk = (dg + kChan - 1) / kChan;
  p.n_chunk = n_chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bwd_proj_kernel<<<tc::proj_grid(L, dg, N, batch * G), tc::kGemmThreads,
                    tc::proj_smem<float>(), s>>>(p, wdt, wbc, P);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return dispatch_bwd<true>(p, batch, s);
}

// K5. u / du as for sigma_scan_proj_bwd (du is added to); dd: (batch, G,
// L, dg); dbc: (batch, G, L, 2N), [dB | dC] summed over channel blocks, dC
// routed; wdt: (G, dg, dg); wbc: (G, dg, 2N), [W_B | W_C]; dW: (n_l *
// batch, G, dg, dg + 2N) partials, n_l token splits per batch element.
int sigma_proj_grad(const float* u0, const float* u1, float* du0, float* du1,
                    const float* dd, const float* dbc, const float* wdt,
                    const float* wbc, float* dW, int batch, int G, int L,
                    int dg, int N, int n_u, int n_l, void* stream) {
  if (bad_shape(batch, G, L, dg, N, n_u) || n_l <= 0 ||
      (size_t)G * batch * n_l > 65535 ||
      (L + tc::kBM - 1) / tc::kBM > 65535)
    return kErrArguments;
  GradArgs p = {};
  p.u[0] = u0;
  p.u[1] = u1;
  p.du[0] = du0;
  p.du[1] = du1;
  p.dd = dd;
  p.dbc = dbc;
  p.wdt = wdt;
  p.wbc = wbc;
  p.dW = dW;
  p.batch = batch;
  p.G = G;
  p.L = L;
  p.dg = dg;
  p.N = N;
  p.n_u = n_u;
  p.n_l = n_l;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_d = (dg + tc::kBM - 1) / tc::kBM;
  const dim3 gw(tiles_d, tiles_d + (2 * N + tc::kBN - 1) / tc::kBN,
                G * batch * n_l);
  weight_grad_kernel<<<gw, tc::kGemmThreads, tc::kAsyncSmem, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 gu(tiles_d, (L + tc::kBM - 1) / tc::kBM, G * batch);
  du_chain_kernel<<<gu, tc::kGemmThreads, tc::kAsyncSmem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* sigma_scan_bwd_error_string(int code) {
  switch (code) {
    case kErrStateWidth:
      return "d_state above 16 is not supported by the scan kernels";
    case kErrArguments:
      return "invalid scan backward arguments";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
