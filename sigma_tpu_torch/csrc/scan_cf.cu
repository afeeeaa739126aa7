// Channel-first chunked selective scan for Hopper (sm_90a), fp32, plain C
// interface for ctypes. Built by sigma_tpu_torch/ops/_build.py with nvcc.
//
// Replaces the core of selective_scan(backend="pallas"):
//   K8 — sigma_tpu/ops/pallas_scan.py::_fwd_kernel (:41, pallas_call :94 in
//      _fwd_call): the chunk scan of csrc/chunk_fwd.cuh (CfSrc);
//   K9 scan_cf_bwd_kernel — sigma_tpu/ops/pallas_scan_bwd.py::_bwd_kernel
//      (:49, pallas_call :176 in selective_scan_pallas_bwd).
// Layout of the reference's CUDA extension: a row r = (batch, group g) holds
// dg channels, each with its L tokens contiguous. Per channel e, state n:
//     a_t = exp(d_t A_en)    h_t = a_t h_{t-1} + d_t u_t B_nt
//     y_t = sum_n C_nt h_t
// with d the effective delta (bias and softplus applied by the caller, as
// the TPU kernels take it) and the D skip left to the caller. Backward,
// with dh_t the cotangent of h_t, dh_t = C_t dy_t + a_{t+1} dh_{t+1}:
//     du_t = d_t sum_n dh_t B_nt          dd_t = sum_n dh_t (A a_t h_{t-1} + u_t B_nt)
//     dA_en = sum_t dh_t a_t h_{t-1} d_t  dB_nt = sum_e dh_t d_t u_t
//     dC_nt = sum_e h_t dy_t
//
// K8. Bound: device memory. It reads u and d and writes y, 12 bytes per
// token and channel, plus B and C once per row (at sigma_tiny's stage 0,
// batch 2, 4 directions: about 374 MB, 0.11 ms at 3.35 TB/s), against 9N
// flops (0.06 ms at 67 TFLOP/s). Design: the three-pass chunk scan that
// K1, K2 and K10 run (csrc/chunk_fwd.cuh), over a channel-first operand
// source (CfSrc): 128-token chunks from a zero state, the fixed-order
// carry pass, the emission. Work spreads over (chunk, 32 channels, row):
// 7,200 blocks at sigma_tiny's trunk stage 0. The body's other sources
// read one row of 32 channels per token; here each channel's (and
// state's) tokens are contiguous, so the source is token-major
// (kTokenMajor): a block's u / d tile is 32 runs of 512 bytes, transposed
// into the body's walk slots as it is staged, and y leaves the same way.
// d_state up to 256 through the body's state tiles (TILED). A is read in
// the reference's (G dg, N) layout (a_at). For K9, the source keeps every
// 8th 32-token checkpoint of the body, the carry into each kChunk =
// 256-token chunk, in K9's layout hck (rows, nl, dg, N).
//
// K9 (after the reference's chunked cub scan; still sequential over the
// chunks) walks the 256-token chunks last to first, one warp per channel.
// Per chunk and state it recomputes h from the saved carry with a forward
// shuffle scan over 32 lanes of 8 tokens, then runs the adjoint
// as a suffix scan of the same operator over the lanes (shuffle down):
// a_{t+1} at a lane's last token is the next lane's first a, or, at the
// chunk's end, exp(d A) of the next chunk's first token
// (pallas_scan_bwd.py:86-89). du, dd accumulate per token in registers, dA
// per (channel, state) in shared memory. dB/dC sum over the channels of
// a group, which span blocks: each warp leaves its per-token terms in
// shared memory, the block sums them (one thread per token, a fixed
// order) and writes one partial per channel tile, (tiles, rows, N, L);
// the caller sums the partials. No atomics: a rerun gives the same bits.
//
// Both launch on the caller's stream, allocate nothing, and return
// cudaGetLastError(). Ragged chunks and channel tiles are masked: a token
// past L has d = 0 (a = 1, b = 0) and is not written.

#include <cuda_runtime.h>

#include <cstddef>

#include "chunk_fwd.cuh"

namespace {

constexpr int kItems = 8;                        // consecutive tokens a lane scans
constexpr int kChunk = 32 * kItems;              // tokens per chunk
constexpr int kLdT = kChunk + kChunk / kItems;   // padded staging row
constexpr int kStates = 16;                      // B/C states staged at a time
constexpr int kMaxState = 256;
constexpr int kWarpsB = kChunk / 32;             // K9: one thread per token sums
constexpr unsigned kFull = 0xffffffffu;

constexpr int kErrStateWidth = 10001;
constexpr int kErrArguments = 10003;

// staging slot of chunk token t: lane l's run starts at l * (kItems + 1),
// so the 32 lanes reading item k of their runs hit 32 distinct banks
__device__ __forceinline__ int slot(int t) { return t + t / kItems; }

// inclusive scan over the lanes, lane 0 first, of h -> a h + b: each lane
// ends with the composition of lanes 0..lane
__device__ __forceinline__ void scan_up(float& a, float& b, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float qa = __shfl_up_sync(kFull, a, off);
    const float qb = __shfl_up_sync(kFull, b, off);
    if (lane >= off) {
      b = fmaf(a, qb, b);
      a *= qa;
    }
  }
}

// suffix scan over the lanes, lane 31 first, of x -> s + p x (x the
// adjoint after the run): each lane ends with lanes lane..31 composed
__device__ __forceinline__ void scan_down(float& p, float& s, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float qp = __shfl_down_sync(kFull, p, off);
    const float qs = __shfl_down_sync(kFull, s, off);
    if (lane + off < 32) {
      s = fmaf(p, qs, s);
      p *= qp;
    }
  }
}

// rows of B/C states [n0, n0 + ns) at chunk c into the staging buffers
__device__ __forceinline__ void stage_bc(float* Bs, float* Cs,
                                         const float* B_r, const float* C_r,
                                         int n0, int ns, int c, int L) {
  for (int i = threadIdx.x; i < ns * kChunk; i += blockDim.x) {
    const int j = i / kChunk, t = i % kChunk, tt = c * kChunk + t;
    const size_t off = (size_t)(n0 + j) * L + tt;
    Bs[j * kLdT + slot(t)] = tt < L ? B_r[off] : 0.f;
    Cs[j * kLdT + slot(t)] = tt < L ? C_r[off] : 0.f;
  }
}

// ---------------------------------------------------------------- K8
// K8's operands for the chunk scan (csrc/chunk_fwd.cuh): u, d, y (rows, dg,
// L) and Bm, Cm (rows, N, L), row r = b G + g; hck null or (rows, nl, dg,
// N); A (G dg, N). The body's bias and D are null: the caller applies
// them.
struct CfSrc : chunk::FwdArgs {
  static constexpr bool kTokenMajor = true;
  const float* u;
  const float* d;
  const float* Bm;
  const float* Cm;
  float* y;
  int nl;

  struct View {
    const float *u, *d, *Bm, *Cm;
    float* y;
    float* hck;
    int L, dg, N;
    __device__ float u_at(int t, int e) const { return u[(size_t)e * L + t]; }
    __device__ float dt_at(int t, int e) const {
      return d[(size_t)e * L + t];
    }
    __device__ float b_at(int t, int n) const {
      return Bm[(size_t)n * L + t];
    }
    __device__ float c_at(int t, int n) const {
      return Cm[(size_t)n * L + t];
    }
    __device__ void put_y(int t, int e, float v) const {
      y[(size_t)e * L + t] = v;
    }
    // checkpoint j enters token 32 j: every kChunk / 32-th is K9's carry
    __device__ void put_hck(int j, int n, int e, float v) const {
      constexpr int kEvery = kChunk / chunk::kSeg;
      if (j % kEvery == 0) hck[((size_t)(j / kEvery) * dg + e) * N + n] = v;
    }
  };
  __device__ float a_at(int g, int n, int e) const {
    return A[((size_t)g * dg + e) * N + n];
  }
  __device__ bool rev(int) const { return false; }
  __device__ View view(int b, int g) const {
    const size_t r = (size_t)b * G + g;
    return View{u + r * dg * L, d + r * dg * L, Bm + r * N * L,
                Cm + r * N * L, y + r * dg * L,
                hck ? hck + r * nl * dg * N : nullptr, L, dg, N};
  }
};
static_assert(kChunk % chunk::kSeg == 0, "K9's chunks hold whole segments");

// ---------------------------------------------------------------- K9
__global__ void __launch_bounds__(kWarpsB * 32)
scan_cf_bwd_kernel(const float* __restrict__ u, const float* __restrict__ d,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ Cm,
                   const float* __restrict__ hck,
                   const float* __restrict__ dy, float* __restrict__ du_o,
                   float* __restrict__ dd_o, float* __restrict__ dA,
                   float* __restrict__ dBp, float* __restrict__ dCp, int G,
                   int dg, int L, int N, int nl) {
  extern __shared__ float smem[];
  float* Bs = smem;                      // kStates x kLdT
  float* Cs = Bs + kStates * kLdT;       // kStates x kLdT
  float* rB = Cs + kStates * kLdT;       // kWarpsB x kLdT: each channel's dB_t
  float* rC = rB + kWarpsB * kLdT;       // kWarpsB x kLdT: each channel's dC_t
  float* dhs = rC + kWarpsB * kLdT;      // kWarpsB x N: dh at the later chunk's start
  float* dAs = dhs + kWarpsB * N;        // kWarpsB x N
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int r = blockIdx.y, g = r % G, rows = gridDim.y;
  const int e = blockIdx.x * kWarpsB + w;
  const bool active = e < dg;  // warp-uniform
  const int ec = active ? e : dg - 1;
  const size_t row = (size_t)r * dg + ec;
  const float* u_r = u + row * L;
  const float* d_r = d + row * L;
  const float* dy_r = dy + row * L;
  const float* A_r = A + ((size_t)g * dg + ec) * N;
  const float* B_r = Bm + (size_t)r * N * L;
  const float* C_r = Cm + (size_t)r * N * L;
  float* rB_l = rB + w * kLdT + lane * (kItems + 1);
  float* rC_l = rC + w * kLdT + lane * (kItems + 1);
  for (int i = threadIdx.x; i < 2 * kWarpsB * N; i += blockDim.x)
    dhs[i] = 0.f;  // dhs and dAs

  for (int c = nl - 1; c >= 0; --c) {
    const int t0 = c * kChunk + lane * kItems;
    float dl[kItems], uv[kItems], gy[kItems], gu[kItems], gd[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool ok = t0 + k < L;
      dl[k] = ok ? d_r[t0 + k] : 0.f;
      uv[k] = ok ? u_r[t0 + k] : 0.f;
      gy[k] = ok ? dy_r[t0 + k] : 0.f;
      gu[k] = gd[k] = 0.f;
    }
    const int tn = (c + 1) * kChunk;  // the next chunk's first token
    const float dnext = tn < L ? d_r[tn] : 0.f;
    const float* h0_r = hck + (((size_t)r * nl + c) * dg + ec) * N;
    for (int n0 = 0; n0 < N; n0 += kStates) {
      const int ns = min(kStates, N - n0);
      __syncthreads();
      stage_bc(Bs, Cs, B_r, C_r, n0, ns, c, L);
      __syncthreads();
      for (int j = 0; j < ns; ++j) {
        const int n = n0 + j;
        const float an = A_r[n];
        const float* Bj = Bs + j * kLdT + lane * (kItems + 1);
        const float* Cj = Cs + j * kLdT + lane * (kItems + 1);
        // recompute h_{t-1} for the lane's tokens from the chunk's carry
        float a[kItems], b[kItems], hp[kItems], pa = 1.f, pb = 0.f;
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          a[k] = __expf(dl[k] * an);
          b[k] = dl[k] * uv[k] * Bj[k];
          pb = fmaf(a[k], pb, b[k]);
          pa *= a[k];
        }
        scan_up(pa, pb, lane);
        float ea = __shfl_up_sync(kFull, pa, 1);
        float eb = __shfl_up_sync(kFull, pb, 1);
        if (lane == 0) {
          ea = 1.f;
          eb = 0.f;
        }
        float h = fmaf(ea, h0_r[n], eb);
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          hp[k] = h;
          h = fmaf(a[k], h, b[k]);
        }
        // a1[k] = a_{t+1}: after the lane's last token, the next lane's
        // first a, or the next chunk's first
        float a1[kItems];
#pragma unroll
        for (int k = 0; k + 1 < kItems; ++k) a1[k] = a[k + 1];
        a1[kItems - 1] = __shfl_down_sync(kFull, a[0], 1);
        if (lane == 31) a1[kItems - 1] = __expf(dnext * an);
        float p = 1.f, s = 0.f;
#pragma unroll
        for (int k = kItems - 1; k >= 0; --k) {
          s = fmaf(a1[k], s, Cj[k] * gy[k]);
          p *= a1[k];
        }
        scan_down(p, s, lane);
        float ep = __shfl_down_sync(kFull, p, 1);
        float es = __shfl_down_sync(kFull, s, 1);
        if (lane == 31) {
          ep = 1.f;
          es = 0.f;
        }
        float dh = fmaf(ep, dhs[w * N + n], es);  // dh after the lane's run
        float dA_l = 0.f;
#pragma unroll
        for (int k = kItems - 1; k >= 0; --k) {
          dh = fmaf(a1[k], dh, Cj[k] * gy[k]);
          const float ah = a[k] * hp[k];
          gu[k] = fmaf(dh * dl[k], Bj[k], gu[k]);
          gd[k] = fmaf(dh, fmaf(an, ah, uv[k] * Bj[k]), gd[k]);
          dA_l = fmaf(dh * ah, dl[k], dA_l);
          rB_l[k] = active ? dh * dl[k] * uv[k] : 0.f;
          rC_l[k] = active ? (ah + b[k]) * gy[k] : 0.f;
        }
        const float dh0 = __shfl_sync(kFull, dh, 0);  // dh at the chunk's start
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          dA_l += __shfl_xor_sync(kFull, dA_l, off);
        __syncwarp();  // every lane has read the old dh carry
        if (lane == 0) {
          dhs[w * N + n] = dh0;
          dAs[w * N + n] += dA_l;
        }
        __syncthreads();  // every channel's dB_t / dC_t is in shared memory
        {
          const int t = threadIdx.x, tt = c * kChunk + t;
          float sb = 0.f, sc = 0.f;
#pragma unroll
          for (int v = 0; v < kWarpsB; ++v) {
            sb += rB[v * kLdT + slot(t)];
            sc += rC[v * kLdT + slot(t)];
          }
          if (tt < L) {
            const size_t o =
                (((size_t)blockIdx.x * rows + r) * N + n) * L + tt;
            dBp[o] = sb;
            dCp[o] = sc;
          }
        }
        __syncthreads();  // the sums are read before the next state writes
      }
    }
    if (active) {
#pragma unroll
      for (int k = 0; k < kItems; ++k)
        if (t0 + k < L) {
          du_o[row * L + t0 + k] = gu[k];
          dd_o[row * L + t0 + k] = gd[k];
        }
    }
  }
  __syncwarp();
  if (active)
    for (int n = lane; n < N; n += 32) dA[row * N + n] = dAs[w * N + n];
}

bool bad_args(int rows, int G, int dg, int L, int N, int nl) {
  return rows <= 0 || G <= 0 || rows % G || rows > 65535 || dg <= 0 ||
         L <= 0 || N <= 0 || nl != (L + kChunk - 1) / kChunk;
}

}  // namespace

extern "C" {

// u, d, y: (rows, dg, L) with rows = batch * G, row r of group r % G;
// A: (G * dg, N); Bm, Cm: (rows, N, L); all fp32. Scratch hloc (rows,
// n_chunk, N, dg), sd (rows, n_chunk, dg), n_chunk = ceil(L / 128). hck,
// null or (rows, nl, dg, N) with nl = ceil(L / 256), receives the carry
// into each 256-token chunk.
int sigma_scan_cf_fwd(const float* u, const float* d, const float* A,
                      const float* Bm, const float* Cm, float* y, float* hloc,
                      float* sd, int n_chunk, float* hck, int rows, int G,
                      int dg, int L, int N, int nl, void* stream) {
  if (bad_args(rows, G, dg, L, N, nl) ||
      n_chunk != (L + chunk::kChunk - 1) / chunk::kChunk)
    return kErrArguments;
  if (N > kMaxState) return kErrStateWidth;
  CfSrc p{};
  chunk::set_fwd_args(p, A, nullptr, nullptr, hloc, sd, hck, G, L, dg, N, 0,
                      n_chunk);
  p.u = u;
  p.d = d;
  p.Bm = Bm;
  p.Cm = Cm;
  p.y = y;
  p.nl = nl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 4) return chunk::launch_chunk_scan<CfSrc, 4, false>(p, rows, s);
  if (N <= 8) return chunk::launch_chunk_scan<CfSrc, 8, false>(p, rows, s);
  if (N <= 16) return chunk::launch_chunk_scan<CfSrc, 16, false>(p, rows, s);
  return chunk::launch_chunk_scan<CfSrc, 16, true>(p, rows, s);
}

// Operands as for sigma_scan_cf_fwd, hck as it wrote it, dy like y.
// du, dd: (rows, dg, L); dA: (rows, dg, N), per row (the caller sums the
// batch); dBp, dCp: (ceil(dg / 8), rows, N, L) partials over channel tiles.
int sigma_scan_cf_bwd(const float* u, const float* d, const float* A,
                      const float* Bm, const float* Cm, const float* hck,
                      const float* dy, float* du, float* dd, float* dA,
                      float* dBp, float* dCp, int rows, int G, int dg, int L,
                      int N, int nl, void* stream) {
  if (bad_args(rows, G, dg, L, N, nl)) return kErrArguments;
  if (N > kMaxState) return kErrStateWidth;
  const size_t smem =
      sizeof(float) * (2 * (size_t)(kStates + kWarpsB) * kLdT +
                       2 * (size_t)kWarpsB * N);
  cudaError_t err = cudaFuncSetAttribute(
      scan_cf_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((dg + kWarpsB - 1) / kWarpsB, rows);
  scan_cf_bwd_kernel<<<grid, kWarpsB * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      u, d, A, Bm, Cm, hck, dy, du, dd, dA, dBp, dCp, G, dg, L, N, nl);
  return static_cast<int>(cudaGetLastError());
}

const char* sigma_scan_cf_error_string(int code) {
  switch (code) {
    case kErrStateWidth:
      return "d_state above 256 is not supported by the channel-first scan "
             "kernels";
    case kErrArguments:
      return "invalid channel-first scan arguments";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
