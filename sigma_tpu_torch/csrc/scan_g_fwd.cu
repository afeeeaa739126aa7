// Forward selective-scan kernels for Hopper (sm_90a), plain C interface
// for ctypes. Built by sigma_tpu_torch/ops/_build.py with nvcc.
//
// Replaces sigma_tpu/ops/pallas_scan_g.py::_fwd_kernel, reached through
// _fwd_call (streamed and fused-projection, n_u = 1) and _fwd_call_ml
// (fused-projection, n_u = 2). Semantics per chain g, channel e:
//     d_t = softplus(dt_t + bias_e)                 (softplus optional)
//     h_t = exp(d_t * A_e) * h_{t-1} + d_t * u_t * B_t      (h in R^N, fp32)
//     y_t = <C_t, h_t> + D_e * u_t (+ y_accum_t)
// walked first-to-last, or last-to-first in place for `reverse`.
//
// K1 scan_fwd_kernel — streamed: dt, B, C arrive from device memory.
//   Bound: device memory. Per token and channel it reads u and dt and
//   writes y (fp32: 12 bytes, plus 4 for y_accum), against ~3N flops and N
//   exps, and the recurrence is sequential in L.
//   Design: one thread owns one channel of one (batch, chain) and keeps
//   h[N] in registers while it walks L; u/dt/y are channel-last, so the 64
//   threads of a block touch 64 neighbouring addresses per token. B_t/C_t
//   (N values per token, shared by all channels of the chain) are staged
//   per 64-token tile in shared memory with coalesced loads. Bias,
//   softplus, the D skip and the y_accum add are fused.
//
// K2 scan_proj_fwd_kernel — fused projection: dt = u W_dt, B = u W_B and
//   C = u W_C are computed inside the kernel from a token tile of u staged
//   in shared memory, so the three projection streams never reach device
//   memory (on the TPU they cost ~550 MB of traffic per stage-1 SS2D).
//   Bound: the in-kernel dt projection, 2 dg^2 flops per token and chain on
//   the fp32 CUDA cores (no tensor cores yet), then the sequential scan.
//   Design: a block of 256 threads owns one (batch, chain, 32-channel
//   tile). Per tile of 32 tokens it stages the u tile (and, under swap_c,
//   the partner chain's u tile: CroMB's chain pair (2k, 2k+1) reads C
//   projected from the partner's u with the partner's W_C) in shared
//   memory; all 8 warps then project: B/C cooperatively, dt with each warp
//   one token group over the block's 32 channels (its u reads are
//   shared-memory broadcasts, its W_dt reads one coalesced row segment
//   through L2: W_dt, 2.4 MB at dg = 768, does not fit in shared memory).
//   Warp 0 then runs the recurrence for the 32 channels. The sequential
//   chain is short of parallel work at stage 0 (B*G*dg/32 blocks, 24 for a
//   trunk SS2D), so the projections are spread over 8 warps rather than
//   the one that scans. The B/C projections are recomputed by every
//   channel-tile block of a chain; that redundancy (dg/32 times) is
//   accepted in this first version. The u tile is 32 tokens, halved until
//   the tiles fit the 227 KB of shared memory a block may use (above 48 KB
//   via cudaFuncAttributeMaxDynamicSharedMemorySize).
//
// Both kernels: io fp32 or bf16, state and arithmetic fp32. They launch on
// the caller's stream, allocate nothing, and return cudaGetLastError().
//
// State checkpoints for the backward kernels (csrc/scan_g_bwd.cu): given a
// non-null `hck`, (batch, G, n_ck, N, dg) fp32 with n_ck = ceil(L / kSeg),
// each thread that scans a channel stores its h[N] as it enters checkpoint
// segment j (physical tokens [j*kSeg, (j+1)*kSeg)) in the walk's own
// order: hck[j] is the state before the segment's first token walked
// (token j*kSeg forward, its last token reversed). Checkpointing is a
// template parameter (CK): a null `hck` (eval) launches the instantiation
// without it, so serving pays nothing for checkpoints (a test inside the
// token loop, even never taken, slowed K2's N = 4 walk 1.5-2x).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 64;     // K1: channels per block, one thread each
constexpr int kTile1 = 64;       // K1 token tile
constexpr int kChan2 = 32;       // K2: channels per block (warp 0 scans them)
constexpr int kThreads2 = 256;   // K2: threads per block, all project
constexpr int kGroups2 = kThreads2 / kChan2;  // token groups in dt projection
constexpr int kTile2 = 32;       // K2 largest token tile
constexpr int kTokPerGroup = kTile2 / kGroups2;
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory per block
constexpr int kSeg = 32;  // hck spacing in tokens; scan_g_bwd.cu's segment
static_assert(kSeg % kTile2 == 0, "K2's tiles must align with hck segments");

constexpr int kErrStateWidth = 10001;
constexpr int kErrSharedMemory = 10002;
constexpr int kErrArguments = 10003;

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

// log(1 + e^x) without overflow: max(x, 0) + log1p(e^-|x|)
__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(__expf(-fabsf(x)));
}

// physical token p starts its checkpoint segment in the walk's order
__device__ __forceinline__ bool seg_entry(int p, int L, int reverse) {
  return reverse ? (p == L - 1 || (p + 1) % kSeg == 0) : p % kSeg == 0;
}

// hck[j][n][e] = h[n] as the walk enters segment j = p / kSeg
template <int NT>
__device__ __forceinline__ void store_ck(float* hck_c, int p, int N, int dg,
                                         int e, const float (&h)[NT]) {
  float* dst = hck_c + (size_t)(p / kSeg) * N * dg + e;
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if (n < N) dst[(size_t)n * dg] = h[n];
}

// ---------------------------------------------------------------- K1
template <typename T, int NT, bool CK>
__global__ void __launch_bounds__(kThreads)
scan_fwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ bias,
                const float* __restrict__ Dk, const T* __restrict__ yacc,
                T* __restrict__ y, float* __restrict__ hck, int G, int L,
                int dg, int N, int softplus, int reverse) {
  __shared__ float Bs[kTile1 * NT];
  __shared__ float Cs[kTile1 * NT];
  const int g = blockIdx.y;
  const size_t chain = (size_t)blockIdx.z * G + g;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const bool active = e < dg;
  const int ec = active ? e : 0;
  const T* u_c = u + chain * L * dg;
  const T* dt_c = dt + chain * L * dg;
  const T* B_c = Bm + chain * L * N;
  const T* C_c = Cm + chain * L * N;
  const T* ya_c = yacc ? yacc + chain * L * dg : nullptr;
  T* y_c = y + chain * L * dg;
  float* hck_c =
      hck ? hck + chain * (size_t)((L + kSeg - 1) / kSeg) * N * dg : nullptr;

  float a[NT], h[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    a[n] = n < N ? A[((size_t)g * N + n) * dg + ec] : 0.f;
    h[n] = 0.f;
  }
  const float bias_e = bias[(size_t)g * dg + ec];
  const float d_e = Dk[(size_t)g * dg + ec];

  const int ntiles = (L + kTile1 - 1) / kTile1;
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = (reverse ? ntiles - 1 - it : it) * kTile1;
    const int tl = min(kTile1, L - t0);
    __syncthreads();  // the previous tile's B/C are consumed
    for (int i = threadIdx.x; i < tl * NT; i += kThreads) {
      const int t = i / NT, n = i % NT;
      const bool ok = n < N;
      Bs[i] = ok ? to_f(B_c[(size_t)(t0 + t) * N + n]) : 0.f;
      Cs[i] = ok ? to_f(C_c[(size_t)(t0 + t) * N + n]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    for (int k = 0; k < tl; ++k) {
      const int t = reverse ? tl - 1 - k : k;
      const size_t off = (size_t)(t0 + t) * dg + e;
      if (CK && seg_entry(t0 + t, L, reverse))
        store_ck<NT>(hck_c, t0 + t, N, dg, e, h);
      const float uv = to_f(u_c[off]);
      float dv = to_f(dt_c[off]) + bias_e;
      if (softplus) dv = softplus_f(dv);
      const float du = dv * uv;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        h[n] = __expf(dv * a[n]) * h[n] + du * Bs[t * NT + n];
        acc += Cs[t * NT + n] * h[n];
      }
      acc += d_e * uv;
      if (ya_c) acc += to_f(ya_c[off]);
      y_c[off] = from_f<T>(acc);
    }
  }
}

// ---------------------------------------------------------------- K2
template <typename T>
struct ProjArgs {
  // n_u == 2: u[j] is layout j, (batch, L, dg), and chain g reads u[g];
  // n_u == 1: u[0] is (batch, G, L, dg). ya / y follow u; ya may be null.
  const T* u[2];
  const T* wdt;  // (G, dg, dg)   dt = u @ wdt[g]
  const T* wb;   // (G, dg, N)
  const T* wc;   // (G, dg, N)
  const float* A;     // (G, N, dg)
  const float* bias;  // (G, dg)
  const float* Dk;    // (G, dg)
  const T* ya[2];
  T* y[2];
  float* hck;  // (batch, G, n_ck, N, dg) or null
  int G, L, dg, N, n_u, tl, softplus, reverse, swap_c;
};

template <typename T>
__device__ __forceinline__ size_t chain_offset(const ProjArgs<T>& p, int b,
                                               int g) {
  return p.n_u == 2 ? (size_t)b * p.L * p.dg
                    : ((size_t)b * p.G + g) * p.L * p.dg;
}

template <typename T, int NT, bool CK>
__global__ void __launch_bounds__(kThreads2)
scan_proj_fwd_kernel(const ProjArgs<T> p) {
  extern __shared__ float smem[];
  const int dg = p.dg, N = p.N, L = p.L, tl_max = p.tl;
  const int ld = dg + 1;  // padded row: B/C dot products hit distinct banks
  float* us = smem;                                      // tl x ld
  float* up = us + (size_t)tl_max * ld;                  // tl x ld (swap_c)
  float* Bs = up + (p.swap_c ? (size_t)tl_max * ld : 0);  // tl x NT
  float* Cs = Bs + tl_max * NT;                          // tl x NT
  float* dts = Cs + tl_max * NT;                         // tl x kChan2

  const int g = blockIdx.y, b = blockIdx.z;
  const int gp = p.swap_c ? (g ^ 1) : g;
  const int jg = p.n_u == 2 ? g : 0, jp = p.n_u == 2 ? gp : 0;
  const int lane = threadIdx.x % kChan2;  // channel within the block
  const int q = threadIdx.x / kChan2;     // token group of the dt projection
  const int e = blockIdx.x * kChan2 + lane;
  const bool active = e < dg;
  const bool scanner = threadIdx.x < kChan2;  // warp 0 runs the recurrence
  const int ec = active ? e : 0;
  const T* u_c = p.u[jg] + chain_offset(p, b, g);
  const T* u_p = p.u[jp] + chain_offset(p, b, gp);
  const T* ya_c = p.ya[jg] ? p.ya[jg] + chain_offset(p, b, g) : nullptr;
  T* y_c = p.y[jg] + chain_offset(p, b, g);
  const T* wdt_g = p.wdt + (size_t)g * dg * dg;
  const T* wb_g = p.wb + (size_t)g * dg * N;
  const T* wc_g = p.wc + (size_t)gp * dg * N;
  const float* c_src = p.swap_c ? up : us;
  float* hck_c = p.hck ? p.hck + ((size_t)b * p.G + g) *
                             ((L + kSeg - 1) / kSeg) * N * dg
                       : nullptr;

  float a[NT], h[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    a[n] = n < N ? p.A[((size_t)g * N + n) * dg + ec] : 0.f;
    h[n] = 0.f;
  }
  const float bias_e = p.bias[(size_t)g * dg + ec];
  const float d_e = p.Dk[(size_t)g * dg + ec];

  const int ntiles = (L + tl_max - 1) / tl_max;
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = (p.reverse ? ntiles - 1 - it : it) * tl_max;
    const int tl = min(tl_max, L - t0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < tl * dg; i += kThreads2) {
      const int t = i / dg, d = i % dg;
      us[t * ld + d] = to_f(u_c[(size_t)t0 * dg + i]);
      if (p.swap_c) up[t * ld + d] = to_f(u_p[(size_t)t0 * dg + i]);
    }
    __syncthreads();

    // B_t, C_t for every token of the tile, shared by the block's channels
    for (int i = threadIdx.x; i < tl * NT; i += kThreads2) {
      const int t = i / NT, n = i % NT;
      float sb = 0.f, sc = 0.f;
      if (n < N) {
        const float* ub = us + t * ld;
        const float* uc = c_src + t * ld;
        for (int d = 0; d < dg; ++d) {
          sb += ub[d] * to_f(wb_g[(size_t)d * N + n]);
          sc += uc[d] * to_f(wc_g[(size_t)d * N + n]);
        }
      }
      Bs[i] = sb;
      Cs[i] = sc;
    }
    // dt for channel e at tokens q, q + kGroups2, ...: a warp is one token
    // group, so its u reads are shared-memory broadcasts and its W_dt
    // reads one coalesced row segment
    if (active) {
      float acc[kTokPerGroup];
#pragma unroll
      for (int k = 0; k < kTokPerGroup; ++k) acc[k] = 0.f;
      for (int d = 0; d < dg; ++d) {
        const float w = to_f(wdt_g[(size_t)d * dg + e]);
#pragma unroll
        for (int k = 0; k < kTokPerGroup; ++k) {
          const int t = q + kGroups2 * k;
          if (t < tl) acc[k] += us[t * ld + d] * w;
        }
      }
#pragma unroll
      for (int k = 0; k < kTokPerGroup; ++k) {
        const int t = q + kGroups2 * k;
        if (t < tl) dts[t * kChan2 + lane] = acc[k];
      }
    }
    __syncthreads();  // B/C/dt complete

    if (!scanner || !active) continue;
    // the tile (a divisor of kSeg tokens, aligned) is entered at a
    // checkpoint segment's entry or inside one: test once per tile, out of
    // the sequential loop
    const int entry = p.reverse ? t0 + tl - 1 : t0;
    if (CK && seg_entry(entry, L, p.reverse))
      store_ck<NT>(hck_c, entry, N, dg, e, h);
    for (int k = 0; k < tl; ++k) {
      const int t = p.reverse ? tl - 1 - k : k;
      const size_t off = (size_t)(t0 + t) * dg + e;
      const float uv = us[t * ld + e];
      float dv = dts[t * kChan2 + lane] + bias_e;
      if (p.softplus) dv = softplus_f(dv);
      const float du = dv * uv;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        h[n] = __expf(dv * a[n]) * h[n] + du * Bs[t * NT + n];
        acc += Cs[t * NT + n] * h[n];
      }
      acc += d_e * uv;
      if (ya_c) acc += to_f(ya_c[off]);
      y_c[off] = from_f<T>(acc);
    }
  }
}

template <typename T, int NT>
int launch_scan(const void* u, const void* dt, const float* A, const void* Bm,
                const void* Cm, const float* bias, const float* Dk,
                const void* yacc, void* y, float* hck, int batch, int G,
                int L, int dg, int N, int softplus, int reverse,
                cudaStream_t stream) {
  const dim3 grid((dg + kThreads - 1) / kThreads, G, batch);
  auto kernel = hck ? scan_fwd_kernel<T, NT, true>
                    : scan_fwd_kernel<T, NT, false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), A,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), bias, Dk,
      static_cast<const T*>(yacc), static_cast<T*>(y), hck, G, L, dg, N,
      softplus, reverse);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NT>
int launch_proj(const void* u0, const void* u1, const void* wdt,
                const void* wb, const void* wc, const float* A,
                const float* bias, const float* Dk, const void* ya0,
                const void* ya1, void* y0, void* y1, float* hck, int batch,
                int G, int L, int dg, int N, int n_u, int softplus,
                int reverse, int swap_c, cudaStream_t stream) {
  const size_t n_tiles_u = swap_c ? 2 : 1;
  auto smem_bytes = [&](int tl) {
    return sizeof(float) * (n_tiles_u * tl * (size_t)(dg + 1) +
                            2 * (size_t)tl * NT + (size_t)tl * kChan2);
  };
  int tl = kTile2;
  while (tl > 1 && smem_bytes(tl) > kMaxSmem) tl /= 2;
  const size_t smem = smem_bytes(tl);
  if (smem > kMaxSmem) return kErrSharedMemory;
  auto kernel = hck ? scan_proj_fwd_kernel<T, NT, true>
                    : scan_proj_fwd_kernel<T, NT, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  ProjArgs<T> p;
  p.u[0] = static_cast<const T*>(u0);
  p.u[1] = static_cast<const T*>(u1);
  p.wdt = static_cast<const T*>(wdt);
  p.wb = static_cast<const T*>(wb);
  p.wc = static_cast<const T*>(wc);
  p.A = A;
  p.bias = bias;
  p.Dk = Dk;
  p.ya[0] = static_cast<const T*>(ya0);
  p.ya[1] = static_cast<const T*>(ya1);
  p.y[0] = static_cast<T*>(y0);
  p.y[1] = static_cast<T*>(y1);
  p.hck = hck;
  p.G = G;
  p.L = L;
  p.dg = dg;
  p.N = N;
  p.n_u = n_u;
  p.tl = tl;
  p.softplus = softplus;
  p.reverse = reverse;
  p.swap_c = swap_c;
  const dim3 grid((dg + kChan2 - 1) / kChan2, G, batch);
  kernel<<<grid, kThreads2, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// u, dt, y, yacc: (batch, G, L, dg); Bm, Cm: (batch, G, L, N);
// A: (G, N, dg) fp32; bias, Dk: (G, dg) fp32. yacc may be null; hck, null
// or (batch, G, nck, N, dg) fp32 with nck = ceil(L / kSeg), receives the
// state checkpoints (nck is checked, so the caller's spacing must be kSeg).
int sigma_scan_fwd(const void* u, const void* dt, const float* A,
                   const void* Bm, const void* Cm, const float* bias,
                   const float* Dk, const void* yacc, void* y, float* hck,
                   int nck, int batch, int G, int L, int dg, int N,
                   int softplus, int reverse, int bf16, void* stream) {
  if (batch <= 0 || G <= 0 || L <= 0 || dg <= 0 || N <= 0 || G > 65535 ||
      batch > 65535 || (hck && nck != (L + kSeg - 1) / kSeg))
    return kErrArguments;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SIGMA_SCAN(T, NT)                                                    \
  return launch_scan<T, NT>(u, dt, A, Bm, Cm, bias, Dk, yacc, y, hck, batch, \
                            G, L, dg, N, softplus, reverse, s)
#define SIGMA_SCAN_N(T)       \
  if (N <= 4) SIGMA_SCAN(T, 4); \
  if (N <= 8) SIGMA_SCAN(T, 8); \
  if (N <= 16) SIGMA_SCAN(T, 16);
  if (bf16) {
    SIGMA_SCAN_N(__nv_bfloat16)
  } else {
    SIGMA_SCAN_N(float)
  }
#undef SIGMA_SCAN_N
#undef SIGMA_SCAN
  return kErrStateWidth;
}

// n_u == 2: u0/u1, ya0/ya1, y0/y1 are the two layouts, (batch, L, dg) each,
// and G must be 2; n_u == 1: u0, ya0, y0 are (batch, G, L, dg).
// wdt: (G, dg, dg); wb, wc: (G, dg, N) in the io type; A: (G, N, dg),
// bias, Dk: (G, dg) fp32. swap_c needs G even (chain pairs 2k, 2k+1).
// hck as for sigma_scan_fwd.
int sigma_scan_proj_fwd(const void* u0, const void* u1, const void* wdt,
                        const void* wb, const void* wc, const float* A,
                        const float* bias, const float* Dk, const void* ya0,
                        const void* ya1, void* y0, void* y1, float* hck,
                        int nck, int batch, int G, int L, int dg, int N,
                        int n_u, int softplus, int reverse, int swap_c,
                        int bf16, void* stream) {
  if (batch <= 0 || G <= 0 || L <= 0 || dg <= 0 || N <= 0 || G > 65535 ||
      batch > 65535 || (n_u != 1 && n_u != 2) || (n_u == 2 && G != 2) ||
      (swap_c && G % 2) || (hck && nck != (L + kSeg - 1) / kSeg))
    return kErrArguments;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SIGMA_PROJ(T, NT)                                                   \
  return launch_proj<T, NT>(u0, u1, wdt, wb, wc, A, bias, Dk, ya0, ya1, y0, \
                            y1, hck, batch, G, L, dg, N, n_u, softplus,      \
                            reverse, swap_c, s)
#define SIGMA_PROJ_N(T)       \
  if (N <= 4) SIGMA_PROJ(T, 4); \
  if (N <= 8) SIGMA_PROJ(T, 8); \
  if (N <= 16) SIGMA_PROJ(T, 16);
  if (bf16) {
    SIGMA_PROJ_N(__nv_bfloat16)
  } else {
    SIGMA_PROJ_N(float)
  }
#undef SIGMA_PROJ_N
#undef SIGMA_PROJ
  return kErrStateWidth;
}

const char* sigma_scan_error_string(int code) {
  switch (code) {
    case kErrStateWidth:
      return "d_state above 16 is not supported by the scan kernels";
    case kErrSharedMemory:
      return "the u tile does not fit in shared memory at this dg";
    case kErrArguments:
      return "invalid scan arguments";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
