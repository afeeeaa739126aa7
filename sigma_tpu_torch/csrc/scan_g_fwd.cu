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
// K2 — fused projection: dt = u W_dt, B = u W_B and C = u W_C (under
//   swap_c, chain pair (2k, 2k+1) reads C projected from the partner's u
//   with the partner's W_C: CroMB), then the scan. Four launches, counted
//   as one call by the wrapper:
//   K2a proj_gemm_kernel — [dt | B | C] for every token, once per chain,
//     on the tensor cores (csrc/tc_gemm.cuh), into an fp32 scratch stream
//     P (batch, G, L, dg + 2N) that the wrapper allocates. On the TPU the
//     projections stayed in VMEM to save ~550 MB of traffic per stage-1
//     SS2D; on the card that traffic is about 0.16 ms at 3.35 TB/s, and
//     projecting once per chain instead of once per channel tile (dg / 32
//     times over in the sequential design this replaces) is what counts.
//   K2b chunk_scan_kernel<EMIT = false> — the sequence is cut into chunks
//     of kChunk = 128 tokens (a multiple of the checkpoint segment, the
//     last one ragged); one block per (chunk, 32 channels, chain) scans its
//     chunk from a zero state: each lane folds kItems consecutive tokens
//     into one (a, b) pair of h -> a h + b, a warp-shuffle scan composes
//     the 32 lanes (K8's design, csrc/scan_cf.cu). It writes the chunk's
//     end state (hloc) and its sum of d per channel (sd): the decay across
//     a chunk is exp(A_ne sum_t d_t), so only sd crosses chunks.
//   K2c carry_kernel — one thread per (batch, chain, state, channel) walks
//     the chunks in the walk's order and replaces hloc with the state
//     entering each chunk: a fixed order, no atomics, so y and hck are
//     bit-identical on a rerun.
//   K2d chunk_scan_kernel<EMIT = true> — scans each chunk again from its
//     true carry and writes y (+ D u, + y_accum) and, under CK, every
//     checkpoint entry of the chunk.
//   Bound: operations. The projection is 2 dg (dg + 2N) flops per token and
//   chain (tensor cores; 3xTF32, fp32's accuracy, at fp32 io); the scan ~9N
//   per token,
//   channel and state, twice (K2b, K2d), on the CUDA cores.
//   Work spreads over (chunk, channel tile, chain, batch): about 1,800
//   blocks at trunk stage 0 of an eval SS2D where the sequential design
//   had 24. u, d, B, C and y pass through shared memory in walk order, so
//   every global access is a row of 32 channels (or N states) of one token.
//
// K1 and K2: io fp32 or bf16, state and arithmetic fp32. They launch on the
// caller's stream, allocate nothing, and return cudaGetLastError().
//
// State checkpoints for the backward kernels (csrc/scan_g_bwd.cu): given a
// non-null `hck`, (batch, G, n_ck, N, dg) fp32 with n_ck = ceil(L / kSeg),
// hck[j] is h as the walk enters checkpoint segment j (physical tokens
// [j*kSeg, (j+1)*kSeg)): the state before token j*kSeg forward, before its
// last token (or L - 1) reversed. Checkpointing is a template parameter
// (CK): a null `hck` (eval) launches the instantiation without it, so
// serving pays nothing for checkpoints (a test inside the token loop, even
// never taken, slowed the sequential K2's N = 4 walk 1.5-2x).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "chunk.cuh"
#include "tc_gemm.cuh"

namespace {

using namespace chunk;  // kSeg, kItems, kChunk, phys, slot, scan_up, ...

constexpr int kThreads = 64;     // K1: channels per block, one thread each
constexpr int kTile1 = 64;       // K1 token tile
constexpr int kChan2 = 32;       // K2 scan: channels per block
constexpr int kScanThreads = 256;  // K2 scan: threads per block
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kIlp = 2;          // K2 scan: states scanned together
static_assert(4 % kIlp == 0, "the state widths (4, 8, 16) hold whole groups");

constexpr int kErrStateWidth = 10001;
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
  const T* wbc;  // (G, dg, 2N)   [B | C] = u @ wbc[g]
  const float* A;     // (G, N, dg)
  const float* bias;  // (G, dg)
  const float* Dk;    // (G, dg)
  const T* ya[2];
  T* y[2];
  float* P;     // (batch, G, L, dg + 2N) scratch: [dt | B | C] per token
  float* hloc;  // (batch, G, n_chunk, N, dg) scratch: chunk states, carries
  float* sd;    // (batch, G, n_chunk, dg) scratch: sum of d per chunk
  float* hck;   // (batch, G, n_ck, N, dg) or null
  int G, L, dg, N, n_u, softplus, reverse, swap_c, n_chunk;
};

template <typename T>
__device__ __forceinline__ size_t chain_offset(const ProjArgs<T>& p, int b,
                                               int g) {
  return p.n_u == 2 ? (size_t)b * p.L * p.dg
                    : ((size_t)b * p.G + g) * p.L * p.dg;
}

// K2a: P[b, g, t] = u[b, g, t] [W_dt | W_B | W_C][g], a 64 x 64 tile of
// (token, column) per block on the tensor cores (tc::proj_tile in
// csrc/tc_gemm.cuh; 3xTF32 at fp32 io, exact 1xTF32 at bf16).
template <typename T>
__global__ void __launch_bounds__(tc::kGemmThreads)
proj_gemm_kernel(const ProjArgs<T> p) {
  const int g = blockIdx.z % p.G, b = blockIdx.z / p.G;
  const int dg = p.dg, N = p.N;
  tc::proj_tile<T>(p.u[p.n_u == 2 ? g : 0] + chain_offset(p, b, g),
                   p.wdt + (size_t)g * dg * dg,
                   p.wbc + (size_t)g * dg * 2 * N,
                   p.P + ((size_t)b * p.G + g) * p.L * (dg + 2 * N), p.L, dg,
                   N, blockIdx.x * tc::kBM, blockIdx.y);
}

// K2b (EMIT false) / K2d (EMIT true): one block per (chunk, 32 channels,
// chain); warp w walks channels w, w + 8, w + 16, w + 24 of the tile.
// Both stage the chunk's u, d = softplus(dt + bias), B and C in shared
// memory in walk order, then per channel and state each lane folds its
// kItems tokens into one (a, b) pair and a warp-shuffle scan composes them.
// K2b writes the chunk's state from zero (hloc) and its sum of d (sd).
// K2d starts from the true carry (hloc after K2c), forms h and y for
// every token, stores hck at every 32-token segment entry (CK) and writes
// y (+ y_accum). Tokens past L walk as identities (d = 0: a = 1, b = 0).
template <typename T, int NT, bool EMIT, bool CK>
__global__ void __launch_bounds__(kScanThreads)
chunk_scan_kernel(const ProjArgs<T> p) {
  extern __shared__ float smem[];
  constexpr int kLdC = kChan2 + 1;                  // u / d row pitch
  constexpr int kLdN = NT + 1;                      // B / C row pitch
  float* us = smem;                  // kRows x kLdC: u, then y
  float* ds = us + kRows * kLdC;     // kRows x kLdC: d
  float* bs = ds + kRows * kLdC;     // kRows x kLdN
  float* cs = bs + kRows * kLdN;     // kRows x kLdN
  float* hs = cs + kRows * kLdN;     // NT x kChan2: carry in / state out
  float* hk = hs + NT * kChan2;      // (kChunk / kSeg) x NT x kChan2 (CK)
  const int c = blockIdx.x, e0 = blockIdx.y * kChan2;
  const int g = blockIdx.z % p.G, b = blockIdx.z / p.G;
  const int gp = p.swap_c ? (g ^ 1) : g;
  const int dg = p.dg, N = p.N, L = p.L, kz = dg + 2 * N;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t bg = (size_t)b * p.G + g;
  const float* P_c = p.P + bg * L * kz;
  const float* P_p = p.P + ((size_t)b * p.G + gp) * L * kz;
  const size_t slab = (bg * p.n_chunk + c) * N * dg;  // hloc of this chunk

  // stage the chunk in walk order
  const T* u_c = p.u[p.n_u == 2 ? g : 0] + chain_offset(p, b, g);
  for (int i = threadIdx.x; i < kChunk * kChan2; i += kScanThreads) {
    const int k = i / kChan2, ch = i % kChan2, e = e0 + ch;
    const int t = phys(c, k, p.reverse);
    float uv = 0.f, dv = 0.f;
    if (t < L && e < dg) {
      uv = to_f(u_c[(size_t)t * dg + e]);
      dv = P_c[(size_t)t * kz + e] + p.bias[(size_t)g * dg + e];
      if (p.softplus) dv = softplus_f(dv);
    }
    us[slot(k) * kLdC + ch] = uv;
    ds[slot(k) * kLdC + ch] = dv;
  }
  for (int i = threadIdx.x; i < kChunk * NT; i += kScanThreads) {
    const int k = i / NT, n = i % NT;
    const int t = phys(c, k, p.reverse);
    const bool ok = t < L && n < N;
    bs[slot(k) * kLdN + n] = ok ? P_c[(size_t)t * kz + dg + n] : 0.f;
    if (EMIT)
      cs[slot(k) * kLdN + n] = ok ? P_p[(size_t)t * kz + dg + N + n] : 0.f;
  }
  if (EMIT)
    for (int i = threadIdx.x; i < NT * kChan2; i += kScanThreads) {
      const int n = i / kChan2, e = e0 + i % kChan2;
      hs[i] = n < N && e < dg ? p.hloc[slab + (size_t)n * dg + e] : 0.f;
    }
  __syncthreads();

  for (int ch = warp; ch < kChan2; ch += kScanWarps) {
    const int e = e0 + ch;
    if (e >= dg) break;
    float dk[kItems], uk[kItems], yk[kItems];
    float dsum = 0.f;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int r = slot(lane * kItems + j) * kLdC + ch;
      dk[j] = ds[r];
      uk[j] = us[r];
      yk[j] = 0.f;
      dsum += dk[j];
    }
    // kIlp states at a time, their scans interleaved; a state past N
    // (odd N) has A = 0 and B = C = 0, so it stays zero and adds nothing
    for (int n0 = 0; n0 < N; n0 += kIlp) {
      float ak[kIlp][kItems], bk[kIlp][kItems], fa[kIlp], fb[kIlp];
#pragma unroll
      for (int q = 0; q < kIlp; ++q) {
        const int n = n0 + q;
        const float an = n < N ? p.A[((size_t)g * N + n) * dg + e] : 0.f;
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
      scan_up<kIlp>(fa, fb, lane);
#pragma unroll
      for (int q = 0; q < kIlp; ++q) {
        const int n = n0 + q;
        if (!EMIT) {
          if (lane == 31) hs[n * kChan2 + ch] = fb[q];
          continue;
        }
        // exclusive prefix: the state before this lane's first token
        float xa = __shfl_up_sync(kFull, fa[q], 1);
        float xb = __shfl_up_sync(kFull, fb[q], 1);
        if (lane == 0) {
          xa = 1.f;
          xb = 0.f;
        }
        float h = fmaf(xa, hs[n * kChan2 + ch], xb);
        if (CK && (lane * kItems) % kSeg == 0)
          hk[((lane * kItems / kSeg) * NT + n) * kChan2 + ch] = h;
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          h = fmaf(ak[q][j], h, bk[q][j]);
          yk[j] = fmaf(cs[slot(lane * kItems + j) * kLdN + n], h, yk[j]);
        }
      }
    }
    if (EMIT) {
      const float d_e = p.Dk[(size_t)g * dg + e];
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        us[slot(lane * kItems + j) * kLdC + ch] = fmaf(d_e, uk[j], yk[j]);
    } else {
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        dsum += __shfl_xor_sync(kFull, dsum, off);
      if (lane == 0) p.sd[(bg * p.n_chunk + c) * dg + e] = dsum;
    }
  }
  __syncthreads();

  if (!EMIT) {
    for (int i = threadIdx.x; i < N * kChan2; i += kScanThreads) {
      const int n = i / kChan2, e = e0 + i % kChan2;
      if (e < dg) p.hloc[slab + (size_t)n * dg + e] = hs[i];
    }
    return;
  }
  const T* ya_c = p.ya[p.n_u == 2 ? g : 0];
  if (ya_c) ya_c += chain_offset(p, b, g);
  T* y_c = p.y[p.n_u == 2 ? g : 0] + chain_offset(p, b, g);
  for (int i = threadIdx.x; i < kChunk * kChan2; i += kScanThreads) {
    const int k = i / kChan2, ch = i % kChan2, e = e0 + ch;
    const int t = phys(c, k, p.reverse);
    if (t >= L || e >= dg) continue;
    float v = us[slot(k) * kLdC + ch];
    if (ya_c) v += to_f(ya_c[(size_t)t * dg + e]);
    y_c[(size_t)t * dg + e] = from_f<T>(v);
  }
  if (CK) {
    // segment entries at walk positions 0, kSeg, ...: physical token
    // phys(c, k) starts segment phys / kSeg in the walk's order (reversed,
    // a segment past L - 1 is entered at L - 1 with the same state, and
    // one wholly past L does not exist)
    const int n_ck = (L + kSeg - 1) / kSeg;
    float* hck_c = p.hck + bg * n_ck * N * dg;
    for (int i = threadIdx.x; i < (kChunk / kSeg) * N * kChan2;
         i += kScanThreads) {
      const int s = i / (N * kChan2), n = (i / kChan2) % N;
      const int ch = i % kChan2, e = e0 + ch;
      const int j = phys(c, s * kSeg, p.reverse) / kSeg;
      if (j < n_ck && e < dg)
        hck_c[((size_t)j * N + n) * dg + e] = hk[(s * NT + n) * kChan2 + ch];
    }
  }
}

// K2c: the carry into every chunk, in the walk's order: thread (b, g, n, e)
// replaces hloc[c] (the chunk's state from zero) with the state entering
// chunk c, carry' = exp(A_ne sd[c]) carry + hloc[c], a fixed order.
template <typename T>
__global__ void carry_kernel(const ProjArgs<T> p, int batch) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int dg = p.dg, N = p.N;
  if (i >= (size_t)batch * p.G * N * dg) return;
  const int e = i % dg, n = (i / dg) % N;
  const size_t bg = i / ((size_t)N * dg);
  const float an = p.A[((size_t)(bg % p.G) * N + n) * dg + e];
  walk_carries(p.hloc + (bg * p.n_chunk * N + n) * dg + e,
               p.sd + bg * p.n_chunk * dg + e, (size_t)N * dg, dg, an,
               p.n_chunk, p.reverse);
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

template <typename T, int NT, bool EMIT, bool CK>
int launch_chunks(const ProjArgs<T>& p, int batch, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * kRows * (kChan2 + 1) + 2 * kRows * (NT + 1) +
                       NT * kChan2 + (CK ? kChunk / kSeg * NT * kChan2 : 0));
  auto kernel = chunk_scan_kernel<T, NT, EMIT, CK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.n_chunk, (p.dg + kChan2 - 1) / kChan2, batch * p.G);
  kernel<<<grid, kScanThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// K2: the projection GEMM, the chunk states, the carries, the emission
template <typename T, int NT>
int launch_proj(const ProjArgs<T>& p, int batch, cudaStream_t stream) {
  proj_gemm_kernel<T><<<tc::proj_grid(p.L, p.dg, p.N, batch * p.G),
                         tc::kGemmThreads, tc::proj_smem<T>(), stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int code = launch_chunks<T, NT, false, false>(p, batch, stream);
  if (code) return code;
  const size_t threads = (size_t)batch * p.G * p.N * p.dg;
  carry_kernel<T><<<(threads + 255) / 256, 256, 0, stream>>>(p, batch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return p.hck ? launch_chunks<T, NT, true, true>(p, batch, stream)
               : launch_chunks<T, NT, true, false>(p, batch, stream);
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
// wdt: (G, dg, dg); wbc: (G, dg, 2N) ([W_B | W_C]) in the io type; A: (G,
// N, dg), bias, Dk: (G, dg) fp32. swap_c needs G even (chain pairs 2k,
// 2k+1). Scratch, fp32: P (batch, G, L, dg + 2N), hloc (batch, G, n_chunk,
// N, dg), sd (batch, G, n_chunk, dg) with n_chunk = ceil(L / kChunk).
// hck as for sigma_scan_fwd.
int sigma_scan_proj_fwd(const void* u0, const void* u1, const void* wdt,
                        const void* wbc, const float* A, const float* bias,
                        const float* Dk, const void* ya0, const void* ya1,
                        void* y0, void* y1, float* P, float* hloc, float* sd,
                        int n_chunk, float* hck, int nck, int batch, int G,
                        int L, int dg, int N, int n_u, int softplus,
                        int reverse, int swap_c, int bf16, void* stream) {
  if (batch <= 0 || G <= 0 || L <= 0 || dg <= 0 || N <= 0 || G > 65535 ||
      (size_t)batch * G > 65535 || (n_u != 1 && n_u != 2) ||
      (n_u == 2 && G != 2) || (swap_c && G % 2) ||
      n_chunk != (L + kChunk - 1) / kChunk ||
      (hck && nck != (L + kSeg - 1) / kSeg))
    return kErrArguments;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SIGMA_PROJ(T, NT)                                        \
  {                                                              \
    ProjArgs<T> p;                                               \
    p.u[0] = static_cast<const T*>(u0);                          \
    p.u[1] = static_cast<const T*>(u1);                          \
    p.wdt = static_cast<const T*>(wdt);                          \
    p.wbc = static_cast<const T*>(wbc);                          \
    p.A = A;                                                     \
    p.bias = bias;                                               \
    p.Dk = Dk;                                                   \
    p.ya[0] = static_cast<const T*>(ya0);                        \
    p.ya[1] = static_cast<const T*>(ya1);                        \
    p.y[0] = static_cast<T*>(y0);                                \
    p.y[1] = static_cast<T*>(y1);                                \
    p.P = P;                                                     \
    p.hloc = hloc;                                               \
    p.sd = sd;                                                   \
    p.hck = hck;                                                 \
    p.G = G;                                                     \
    p.L = L;                                                     \
    p.dg = dg;                                                   \
    p.N = N;                                                     \
    p.n_u = n_u;                                                 \
    p.softplus = softplus;                                       \
    p.reverse = reverse;                                         \
    p.swap_c = swap_c;                                           \
    p.n_chunk = n_chunk;                                         \
    return launch_proj<T, NT>(p, batch, s);                      \
  }
#define SIGMA_PROJ_N(T)         \
  if (N <= 4) SIGMA_PROJ(T, 4)  \
  if (N <= 8) SIGMA_PROJ(T, 8)  \
  if (N <= 16) SIGMA_PROJ(T, 16)
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
    case kErrArguments:
      return "invalid scan arguments";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
