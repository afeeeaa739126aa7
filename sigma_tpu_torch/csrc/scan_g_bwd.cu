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
// K3 scan_bwd_kernel<NT, false> — streamed (the stage-3 route): dt, B, C
//   are read from device memory. K4 scan_bwd_kernel<NT, true> — fused
//   projection: dt = u W_dt, B = u W_B, C = u W_C are recomputed from u
//   tiles in shared memory as K2 computes them (under swap_c from the
//   partner chain's u and W_C), so they never reach device memory; its
//   dd / dB / dC streams go to K5.
//   Bound: the sequential walk. Per token and channel the sweep is ~12N
//   flops and N exps in one warp, twice (recompute, then dh), against
//   ~40 bytes of device traffic; K4 adds K2's in-kernel projections
//   (2 dg (dg + 2N) flops per token and chain, fp32 CUDA cores).
//   Design: one block of 256 threads per (batch, chain, 32 channels), as
//   K2. The forward stored h every kSeg = 32 tokens (hck). The block walks
//   those segments last to first (first to last for `reverse`, in place):
//   all 8 warps stage dy/u/dt/B/C (K4: project them), warp 0 recomputes h
//   through the segment into shared memory (32 x N x 32 floats), all warps
//   reduce dC_t = sum_e h_t dy_t over the block's channels, warp 0 sweeps
//   dh back through the segment, leaving dh d u in the slot of the h it no
//   longer needs, and all warps reduce those into dB. The channel sums
//   cross blocks: each block writes its own partial (batch, n_blk, G, L, N)
//   and the caller sums them (the TPU kernel's dg-tile partials are summed
//   the same way, pallas_scan_g.py:1134-1137), so the result does not
//   depend on the blocks' order. dA / dbias / dD are per-batch partials.
//   K4's u tile is halved until the tiles fit the 227 KB a block may use.
//
// K5 weight_grad_kernel + du_chain_kernel (one entry point) — the products
//   the TPU kernel runs in its own body (:594-622): per chain
//   [dW_dt | dW_B | dW_C] = u^T [dd | dB | dC], and
//   du += [dd | dB | dC] [W_dt | W_B | W_C]^T.
//   Bound: fp32 operations, 4 dg (dg + 2N) flops per token and chain on the
//   CUDA cores (no tensor cores yet: wgmma is later work).
//   Design: 64 x 64 output tiles in shared memory, 16-deep K steps, 4 x 4
//   outputs per thread. The weight gradient contracts over all batch*L
//   tokens, so it is split along them into partials (nsplit, G, dg,
//   dg + 2N) that the caller sums; each du element is owned by one block.
//
// All launch on the caller's stream, allocate nothing, and return
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kSeg = 32;       // checkpoint spacing = backward segment
constexpr int kChan = 32;      // channels per block (warp 0 sweeps them)
constexpr int kThreads = 256;  // threads per block, all stage and reduce
constexpr int kWarps = kThreads / kChan;
constexpr int kLdH = kChan + 1;  // padded row of the per-token state store
constexpr size_t kMaxSmem = 232448;

constexpr int kErrStateWidth = 10001;
constexpr int kErrSharedMemory = 10002;
constexpr int kErrArguments = 10003;

__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(__expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + __expf(-x));
}

struct BwdArgs {
  // u / dy / du: n_u == 2: two layouts (batch, L, dg), chain g on layout g;
  // n_u == 1: (batch, G, L, dg) in slot 0
  const float* u[2];
  const float* dy[2];
  float* du[2];
  // streamed: dt (batch, G, L, dg), B / C (batch, G, L, N);
  // projected: W_dt (G, dg, dg), W_B / W_C (G, dg, N)
  const float* dt;
  const float* Bm;
  const float* Cm;
  const float* A;     // (G, N, dg)
  const float* bias;  // (G, dg)
  const float* Dk;    // (G, dg)
  const float* hck;   // (batch, G, nck, N, dg)
  float* dd;          // (batch, G, L, dg) raw-dt cotangent
  float* dA;          // (batch, G, N, dg)
  float* dbias;       // (batch, G, dg)
  float* dD;          // (batch, G, dg)
  float* dBp;         // (batch, nblk, G, L, N) per-block partials
  float* dCp;         // the same; swap_c routes to the projecting chain
  int G, L, dg, N, n_u, tl, softplus, reverse, swap_c, nck, nblk;
};

__device__ __forceinline__ size_t chain_offset(const BwdArgs& p, int b,
                                               int g) {
  return p.n_u == 2 ? (size_t)b * p.L * p.dg
                    : ((size_t)b * p.G + g) * p.L * p.dg;
}

template <int NT, bool PROJ>
__global__ void __launch_bounds__(kThreads)
scan_bwd_kernel(const BwdArgs p) {
  extern __shared__ float smem[];
  const int dg = p.dg, N = p.N, L = p.L;
  const int ld = dg + 1;  // padded u-tile row, as in K2
  const size_t tile = PROJ ? (size_t)p.tl * ld : 0;
  float* us = smem;                                  // tl x ld (K4)
  float* up = us + tile;                             // partner (swap_c)
  float* Bs = up + (PROJ && p.swap_c ? tile : 0);    // kSeg x NT
  float* Cs = Bs + kSeg * NT;                        // kSeg x NT
  float* dts = Cs + kSeg * NT;                       // kSeg x kChan raw dt
  float* useg = dts + kSeg * kChan;                  // kSeg x kChan u
  float* dys = useg + kSeg * kChan;                  // kSeg x kChan dy
  float* hs = dys + kSeg * kChan;                    // (kSeg NT) x kLdH

  const int blk = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int gp = p.swap_c ? (g ^ 1) : g;
  const int jg = p.n_u == 2 ? g : 0, jp = p.n_u == 2 ? gp : 0;
  const int lane = threadIdx.x % kChan, q = threadIdx.x / kChan;
  const int e0 = blk * kChan;
  const int nch = min(kChan, dg - e0);
  const int e = e0 + lane;
  const bool sweeper = q == 0 && lane < nch;  // warp 0 walks the recurrence
  const int ec = lane < nch ? e : e0;
  const size_t chain = (size_t)b * p.G + g;
  const float* u_c = p.u[jg] + chain_offset(p, b, g);
  const float* u_p = p.u[jp] + chain_offset(p, b, gp);
  const float* dy_c = p.dy[jg] + chain_offset(p, b, g);
  float* du_c = p.du[jg] + chain_offset(p, b, g);
  float* dd_c = p.dd + chain * L * dg;
  const float* hck_c = p.hck + chain * p.nck * N * dg;
  float* dB_c = p.dBp + (((size_t)b * p.nblk + blk) * p.G + g) * L * N;
  float* dC_c = p.dCp + (((size_t)b * p.nblk + blk) * p.G + gp) * L * N;
  // streamed operands (K3) or projection weights (K4)
  const float* dt_c = p.dt + (PROJ ? (size_t)g * dg * dg : chain * L * dg);
  const float* B_c = p.Bm + (PROJ ? (size_t)g * dg * N : chain * L * N);
  const float* C_c = p.Cm + (PROJ ? (size_t)gp * dg * N : chain * L * N);

  float Av[NT], dh[NT], dA_acc[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    Av[n] = n < N ? p.A[((size_t)g * N + n) * dg + ec] : 0.f;
    dh[n] = 0.f;
    dA_acc[n] = 0.f;
  }
  const float bias_e = p.bias[(size_t)g * dg + ec];
  const float d_e = p.Dk[(size_t)g * dg + ec];
  float dbias_acc = 0.f, dD_acc = 0.f;

  const int nseg = (L + kSeg - 1) / kSeg;
  for (int it = 0; it < nseg; ++it) {
    const int j = p.reverse ? it : nseg - 1 - it;  // against the walk
    const int t0 = j * kSeg;
    const int sl = min(kSeg, L - t0);
    __syncthreads();  // the previous segment's tiles are consumed

    // ---- stage dy (and K3's u, dt, B, C) for the segment
    for (int i = threadIdx.x; i < sl * kChan; i += kThreads) {
      const int k = i / kChan, c = i % kChan;
      const bool ok = c < nch;
      const size_t off = (size_t)(t0 + k) * dg + e0 + c;
      dys[i] = ok ? dy_c[off] : 0.f;
      if (!PROJ) {
        useg[i] = ok ? u_c[off] : 0.f;
        dts[i] = ok ? dt_c[off] : 0.f;
      }
    }
    if (!PROJ) {
      for (int i = threadIdx.x; i < sl * NT; i += kThreads) {
        const int k = i / NT, n = i % NT;
        const bool ok = n < N;
        Bs[i] = ok ? B_c[(size_t)(t0 + k) * N + n] : 0.f;
        Cs[i] = ok ? C_c[(size_t)(t0 + k) * N + n] : 0.f;
      }
    } else {
      // ---- K4: project dt / B / C from u sub-tiles, as K2 does
      for (int s0 = 0; s0 < sl; s0 += p.tl) {
        const int tn = min(p.tl, sl - s0);
        __syncthreads();  // the previous sub-tile is consumed
        for (int i = threadIdx.x; i < tn * dg; i += kThreads) {
          const int t = i / dg, d = i % dg;
          us[t * ld + d] = u_c[(size_t)(t0 + s0) * dg + i];
          if (p.swap_c) up[t * ld + d] = u_p[(size_t)(t0 + s0) * dg + i];
        }
        __syncthreads();
        const float* c_src = p.swap_c ? up : us;
        for (int i = threadIdx.x; i < tn * NT; i += kThreads) {
          const int t = i / NT, n = i % NT;
          float sb = 0.f, sc = 0.f;
          if (n < N) {
            const float* ub = us + t * ld;
            const float* uc = c_src + t * ld;
            for (int d = 0; d < dg; ++d) {
              sb += ub[d] * B_c[(size_t)d * N + n];
              sc += uc[d] * C_c[(size_t)d * N + n];
            }
          }
          Bs[(s0 + t) * NT + n] = sb;
          Cs[(s0 + t) * NT + n] = sc;
        }
        if (lane < nch) {
          // warp q projects dt for tokens q, q + kWarps, ... of the sub-tile
          float acc[kSeg / kWarps];
#pragma unroll
          for (int k = 0; k < kSeg / kWarps; ++k) acc[k] = 0.f;
          for (int d = 0; d < dg; ++d) {
            const float w = dt_c[(size_t)d * dg + e];
#pragma unroll
            for (int k = 0; k < kSeg / kWarps; ++k) {
              const int t = q + kWarps * k;
              if (t < tn) acc[k] += us[t * ld + d] * w;
            }
          }
#pragma unroll
          for (int k = 0; k < kSeg / kWarps; ++k) {
            const int t = q + kWarps * k;
            if (t < tn) dts[(s0 + t) * kChan + lane] = acc[k];
          }
        }
        for (int i = threadIdx.x; i < tn * kChan; i += kThreads) {
          const int t = i / kChan, c = i % kChan;
          useg[(s0 + t) * kChan + c] = c < nch ? us[t * ld + e0 + c] : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- recompute h through the segment from its checkpoint: hs[k] = h
    // after physical token t0 + k
    if (sweeper) {
      float h[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        h[n] = n < N ? hck_c[((size_t)j * N + n) * dg + e] : 0.f;
      for (int i = 0; i < sl; ++i) {
        const int k = p.reverse ? sl - 1 - i : i;
        float dv = dts[k * kChan + lane] + bias_e;
        if (p.softplus) dv = softplus_f(dv);
        const float du = dv * useg[k * kChan + lane];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          h[n] = __expf(dv * Av[n]) * h[n] + du * Bs[k * NT + n];
          hs[(k * NT + n) * kLdH + lane] = h[n];
        }
      }
    }
    __syncthreads();

    // ---- dC_t = sum over the block's channels of h_t dy_t
    for (int o = threadIdx.x; o < sl * NT; o += kThreads) {
      const int k = o / NT, n = o % NT;
      if (n >= N) continue;
      const float* hr = hs + (size_t)(k * NT + n) * kLdH;
      const float* dr = dys + k * kChan;
      float s = 0.f;
      for (int c = 0; c < nch; ++c) s += hr[c] * dr[c];
      dC_c[(size_t)(t0 + k) * N + n] = s;
    }
    __syncthreads();

    // ---- the dh sweep, against the walk; hs[k] becomes dh_t d_t u_t
    if (sweeper) {
      for (int i = 0; i < sl; ++i) {
        const int k = p.reverse ? i : sl - 1 - i;
        const bool first = p.reverse ? k == sl - 1 : k == 0;
        const int kp = p.reverse ? k + 1 : k - 1;  // the previous token
        const float pre = dts[k * kChan + lane] + bias_e;
        const float dv = p.softplus ? softplus_f(pre) : pre;
        const float uv = useg[k * kChan + lane];
        const float dyv = dys[k * kChan + lane];
        const float dvu = dv * uv;
        float sb = 0.f, sa = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          float hp;
          if (first)
            hp = n < N ? hck_c[((size_t)j * N + n) * dg + e] : 0.f;
          else
            hp = hs[(kp * NT + n) * kLdH + lane];
          const float a = __expf(dv * Av[n]);
          const float ahp = a * hp;
          dh[n] += Cs[k * NT + n] * dyv;
          sb += dh[n] * Bs[k * NT + n];
          sa += dh[n] * Av[n] * ahp;
          dA_acc[n] += dh[n] * ahp * dv;
          hs[(k * NT + n) * kLdH + lane] = dh[n] * dvu;
          dh[n] *= a;
        }
        const float ddv = sa + uv * sb;
        const float ddr = p.softplus ? ddv * sigmoid_f(pre) : ddv;
        dbias_acc += ddr;
        dD_acc += dyv * uv;
        const size_t off = (size_t)(t0 + k) * dg + e;
        du_c[off] = dv * sb + d_e * dyv;
        dd_c[off] = ddr;
      }
    }
    __syncthreads();

    // ---- dB_t = sum over the block's channels of dh_t d_t u_t
    for (int o = threadIdx.x; o < sl * NT; o += kThreads) {
      const int k = o / NT, n = o % NT;
      if (n >= N) continue;
      const float* hr = hs + (size_t)(k * NT + n) * kLdH;
      float s = 0.f;
      for (int c = 0; c < nch; ++c) s += hr[c];
      dB_c[(size_t)(t0 + k) * N + n] = s;
    }
  }

  if (sweeper) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (n < N) p.dA[(chain * N + n) * dg + e] = dA_acc[n];
    p.dbias[chain * dg + e] = dbias_acc;
    p.dD[chain * dg + e] = dD_acc;
  }
}

template <int NT, bool PROJ>
int launch_bwd(BwdArgs p, int batch, cudaStream_t stream) {
  auto smem_bytes = [&](int tl) {
    const size_t n_tiles = PROJ ? (p.swap_c ? 2 : 1) : 0;
    return sizeof(float) *
           (n_tiles * tl * (size_t)(p.dg + 1) + 2 * (size_t)kSeg * NT +
            3 * (size_t)kSeg * kChan + (size_t)kSeg * NT * kLdH);
  };
  int tl = kSeg;
  while (PROJ && tl > 1 && smem_bytes(tl) > kMaxSmem) tl /= 2;
  const size_t smem = smem_bytes(tl);
  if (smem > kMaxSmem) return kErrSharedMemory;
  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd_kernel<NT, PROJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  p.tl = tl;
  const dim3 grid(p.nblk, p.G, batch);
  scan_bwd_kernel<NT, PROJ><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool PROJ>
int dispatch_bwd(const BwdArgs& p, int batch, cudaStream_t s) {
  if (p.N <= 4) return launch_bwd<4, PROJ>(p, batch, s);
  if (p.N <= 8) return launch_bwd<8, PROJ>(p, batch, s);
  if (p.N <= 16) return launch_bwd<16, PROJ>(p, batch, s);
  return kErrStateWidth;
}

// ---------------------------------------------------------------- K5
constexpr int kTile = 64;   // output tile edge
constexpr int kDepth = 16;  // K step
constexpr int kLdT = kTile + 4;  // padded smem row, 16-byte aligned

struct GradArgs {
  const float* u[2];  // as BwdArgs
  float* du[2];
  const float* dd;    // (batch, G, L, dg)
  const float* dB;    // (batch, G, L, N)
  const float* dC;    // (batch, G, L, N), already routed to its chain
  const float* wdt;   // (G, dg, dg)
  const float* wb;    // (G, dg, N)
  const float* wc;    // (G, dg, N)
  float* dW;          // (nsplit, G, dg, dg + 2N)
  int batch, G, L, dg, N, n_u, nsplit;
};

// row r = b L + t of chain g's u / du
__device__ __forceinline__ size_t u_row(const GradArgs& p, int g, int r) {
  const int b = r / p.L, t = r % p.L;
  return (p.n_u == 2 ? (size_t)b * p.L + t
                     : ((size_t)b * p.G + g) * p.L + t) * p.dg;
}

// Z[r, k] = [dd | dB | dC] of chain g
__device__ __forceinline__ float z_at(const GradArgs& p, int g, int r,
                                      int k) {
  const int b = r / p.L, t = r % p.L;
  const size_t tok = ((size_t)b * p.G + g) * p.L + t;
  if (k < p.dg) return p.dd[tok * p.dg + k];
  k -= p.dg;
  if (k < p.N) return p.dB[tok * p.N + k];
  return p.dC[tok * p.N + k - p.N];
}

// W[d, k] = [W_dt | W_B | W_C] of chain g, row d
__device__ __forceinline__ float w_at(const GradArgs& p, int g, int d,
                                      int k) {
  if (k < p.dg) return p.wdt[((size_t)g * p.dg + d) * p.dg + k];
  k -= p.dg;
  if (k < p.N) return p.wb[((size_t)g * p.dg + d) * p.N + k];
  return p.wc[((size_t)g * p.dg + d) * p.N + k - p.N];
}

// acc[i][j] += sum_kk As[kk][ty*4+i] Bs[kk][tx*4+j]
__device__ __forceinline__ void tile_fma(float (*As)[kLdT],
                                         float (*Bs)[kLdT], int ty, int tx,
                                         float (&acc)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < kDepth; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[i][jj] += av[i] * bv[jj];
  }
}

// dW[s, g, d, k] = sum over split s's rows r of u[r, d] Z[r, k]
__global__ void __launch_bounds__(256) weight_grad_kernel(const GradArgs p) {
  __shared__ __align__(16) float As[kDepth][kLdT];
  __shared__ __align__(16) float Bs[kDepth][kLdT];
  const int g = blockIdx.z % p.G, s = blockIdx.z / p.G;
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int kz = p.dg + 2 * p.N, R = p.batch * p.L;
  const int rows = (R + p.nsplit - 1) / p.nsplit;
  const int r_begin = s * rows, r_end = min(R, r_begin + rows);
  const float* u = p.u[p.n_u == 2 ? g : 0];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int r0 = r_begin; r0 < r_end; r0 += kDepth) {
    for (int i = threadIdx.x; i < kDepth * kTile; i += 256) {
      const int kk = i / kTile, m = i % kTile;
      const int r = r0 + kk;
      const bool row_ok = r < r_end;
      As[kk][m] = row_ok && m0 + m < p.dg ? u[u_row(p, g, r) + m0 + m] : 0.f;
      Bs[kk][m] = row_ok && n0 + m < kz ? z_at(p, g, r, n0 + m) : 0.f;
    }
    __syncthreads();
    tile_fma(As, Bs, ty, tx, acc);
    __syncthreads();
  }
  float* out = p.dW + ((size_t)s * p.G + g) * p.dg * kz;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = m0 + ty * 4 + i;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int k = n0 + tx * 4 + jj;
      if (d < p.dg && k < kz) out[(size_t)d * kz + k] = acc[i][jj];
    }
  }
}

// du[r, d] += sum_k Z[r, k] W[d, k]
__global__ void __launch_bounds__(256) du_chain_kernel(const GradArgs p) {
  __shared__ __align__(16) float As[kDepth][kLdT];
  __shared__ __align__(16) float Bs[kDepth][kLdT];
  const int g = blockIdx.z;
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int kz = p.dg + 2 * p.N, R = p.batch * p.L;
  float* du = p.du[p.n_u == 2 ? g : 0];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < kz; k0 += kDepth) {
    for (int i = threadIdx.x; i < kDepth * kTile; i += 256) {
      const int kk = i % kDepth, m = i / kDepth;  // k fastest: row reads
      const int k = k0 + kk;
      As[kk][m] = m0 + m < R && k < kz ? z_at(p, g, m0 + m, k) : 0.f;
      Bs[kk][m] = n0 + m < p.dg && k < kz ? w_at(p, g, n0 + m, k) : 0.f;
    }
    __syncthreads();
    tile_fma(As, Bs, ty, tx, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= R) continue;
    float* row = du + u_row(p, g, r);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int d = n0 + tx * 4 + jj;
      if (d < p.dg) row[d] += acc[i][jj];
    }
  }
}

bool bad_shape(int batch, int G, int L, int dg, int N, int n_u) {
  return batch <= 0 || G <= 0 || L <= 0 || dg <= 0 || N <= 0 ||
         G > 65535 || batch > 65535 || (n_u != 1 && n_u != 2) ||
         (n_u == 2 && G != 2);
}

}  // namespace

extern "C" {

// K3. u, dt, dy, du, dd: (batch, G, L, dg); Bm, Cm: (batch, G, L, N);
// A: (G, N, dg); bias, Dk: (G, dg); hck: (batch, G, nck, N, dg) from K1;
// dA: (batch, G, N, dg); dbias, dD: (batch, G, dg);
// dBp, dCp: (batch, ceil(dg / 32), G, L, N). All fp32.
int sigma_scan_bwd(const float* u, const float* dt, const float* A,
                   const float* Bm, const float* Cm, const float* bias,
                   const float* Dk, const float* hck, const float* dy,
                   float* du, float* dd, float* dA, float* dbias, float* dD,
                   float* dBp, float* dCp, int batch, int G, int L, int dg,
                   int N, int nck, int softplus, int reverse, void* stream) {
  if (bad_shape(batch, G, L, dg, N, 1) || nck != (L + kSeg - 1) / kSeg)
    return kErrArguments;
  BwdArgs p = {};
  p.u[0] = u;
  p.dy[0] = dy;
  p.du[0] = du;
  p.dt = dt;
  p.Bm = Bm;
  p.Cm = Cm;
  p.A = A;
  p.bias = bias;
  p.Dk = Dk;
  p.hck = hck;
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
  return dispatch_bwd<false>(p, batch, static_cast<cudaStream_t>(stream));
}

// K4. n_u == 2: u0/u1, dy0/dy1, du0/du1 are the two layouts (batch, L, dg)
// and G == 2; n_u == 1: slot 0 is (batch, G, L, dg). wdt: (G, dg, dg);
// wb, wc: (G, dg, N); the rest as for sigma_scan_bwd, with dCp routed to
// the partner chain under swap_c (G even).
int sigma_scan_proj_bwd(const float* u0, const float* u1, const float* wdt,
                        const float* wb, const float* wc, const float* A,
                        const float* bias, const float* Dk, const float* hck,
                        const float* dy0, const float* dy1, float* du0,
                        float* du1, float* dd, float* dA, float* dbias,
                        float* dD, float* dBp, float* dCp, int batch, int G,
                        int L, int dg, int N, int nck, int n_u, int softplus,
                        int reverse, int swap_c, void* stream) {
  if (bad_shape(batch, G, L, dg, N, n_u) || (swap_c && G % 2) ||
      nck != (L + kSeg - 1) / kSeg)
    return kErrArguments;
  BwdArgs p = {};
  p.u[0] = u0;
  p.u[1] = u1;
  p.dy[0] = dy0;
  p.dy[1] = dy1;
  p.du[0] = du0;
  p.du[1] = du1;
  p.dt = wdt;
  p.Bm = wb;
  p.Cm = wc;
  p.A = A;
  p.bias = bias;
  p.Dk = Dk;
  p.hck = hck;
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
  return dispatch_bwd<true>(p, batch, static_cast<cudaStream_t>(stream));
}

// K5. u / du as for sigma_scan_proj_bwd (du is added to); dd: (batch, G, L,
// dg); dB, dC: (batch, G, L, N) summed over channel blocks, dC routed;
// weights as there; dW: (nsplit, G, dg, dg + 2N) partials.
int sigma_proj_grad(const float* u0, const float* u1, float* du0, float* du1,
                    const float* dd, const float* dB, const float* dC,
                    const float* wdt, const float* wb, const float* wc,
                    float* dW, int batch, int G, int L, int dg, int N,
                    int n_u, int nsplit, void* stream) {
  if (bad_shape(batch, G, L, dg, N, n_u) || nsplit <= 0 || nsplit > 65535 ||
      (size_t)G * nsplit > 65535 || (size_t)batch * L > 2147483647u)
    return kErrArguments;
  GradArgs p = {};
  p.u[0] = u0;
  p.u[1] = u1;
  p.du[0] = du0;
  p.du[1] = du1;
  p.dd = dd;
  p.dB = dB;
  p.dC = dC;
  p.wdt = wdt;
  p.wb = wb;
  p.wc = wc;
  p.dW = dW;
  p.batch = batch;
  p.G = G;
  p.L = L;
  p.dg = dg;
  p.N = N;
  p.n_u = n_u;
  p.nsplit = nsplit;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kz = dg + 2 * N, R = batch * L;
  const dim3 gw((dg + kTile - 1) / kTile, (kz + kTile - 1) / kTile,
                G * nsplit);
  weight_grad_kernel<<<gw, 256, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 gu((R + kTile - 1) / kTile, (dg + kTile - 1) / kTile, G);
  du_chain_kernel<<<gu, 256, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* sigma_scan_bwd_error_string(int code) {
  switch (code) {
    case kErrStateWidth:
      return "d_state above 16 is not supported by the scan kernels";
    case kErrSharedMemory:
      return "the backward tiles do not fit in shared memory at this dg";
    case kErrArguments:
      return "invalid scan backward arguments";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
