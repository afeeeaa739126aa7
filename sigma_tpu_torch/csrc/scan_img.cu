// Image-layout SS2D scan for Hopper (sm_90a), plain C interface for ctypes.
// Built by sigma_tpu_torch/ops/_build.py with nvcc.
//
// Replaces sigma_tpu/ops/pallas_scan_g.py's image kernels, reached through
// selective_scan_ss2d_proj (:2371):
//   K10 — _fwd_kernel_img (:1856), via _fwd_call_img (:2217, pallas_call
//       :2249): img_proj_kernel, then the chunk scan of csrc/chunk_fwd.cuh;
//   K11 — _bwd_kernel_img (:1942), via _bwd_call_img (:2270, pallas_call
//       :2323): img_proj_bwd_kernel, then the chunk backward of
//       csrc/chunk_bwd.cuh; its weight gradients and du chain term (the TPU
//       body's dots :2086-2108) run on K5 (csrc/scan_g_bwd.cu).
// One call covers the four SS2D directions of one (batch, H, W, dg) image
// x: chain c = 2 * dir + layout, with layout 0 (hw) walking the pixels in
// row-major order and layout 1 (wh) in column-major order, dir 0 first to
// last and dir 1 last to first. Per chain c, channel e, state n:
//     dt = x_t W_dt[c]    B = x_t W_B[c]    C = x_t W_C[c]   (in-kernel)
//     d_t = softplus(dt_e + bias_e)                  (softplus optional)
//     h_t = exp(d_t A_ne) h_{t-1} + d_t x_te B_tn     (fp32 state)
//     y_t = sum_n C_tn h_tn + D_e x_te
// and the CrossMerge output is the sum of the four chains' y in image
// order (the wrapper sums the four planes K10 writes, as the JAX wrapper
// sums outside its kernel, :2341). Token t of the wh layout is pixel
// (t % H, t / H): the transpose is only addressing, and the channels of one
// pixel are one contiguous row in either layout. No transposed copy of x,
// y, dy or du exists.
//
// K10. Bound: operations, the projections (2 dg (dg + 2N) per token and
// chain, tensor cores) and the scan (~9 N per token, chain, channel and
// state, fp32 cores). Design: K2's before its Hopper rebuild (a
// projection, then K1's chunk scan), four launches counted as one call by
// the wrapper.
//   img_proj_kernel — [dt | B | C] once per (chain, batch) on the tensor
//     cores with mma.sync tiles (tc::proj_tile; 3xTF32 at fp32 io, exact
//     1xTF32 at bf16) into an fp32 scratch P (batch, 4, L, dg + 2N) in each
//     chain's token order; the x rows of a wh tile are gathered through the
//     pixel map, one contiguous row per token (the tile's loads are per row
//     anyway).
//   then the chunk scan of csrc/chunk_fwd.cuh over the four chains (ImgSrc):
//     128-token chunks from a zero state, a fixed-order carry pass, the
//     emission, u read and y written through the same pixel map, dir 1
//     reversed in place. d_state up to 256: the chunk body walks state
//     tiles of 16 inside the block (TILED), y summed over the tiles in a
//     fixed order by the thread that owns it.
//   It writes y as one plane per chain, and under a gradient the
//   checkpoints K11 reads: hck[c][b][j] = h as chain c's walk enters
//   32-token segment j of its sequence.
//
// K11. Bound: operations, as K10: the re-projections on the tensor cores
// and the scan backward (~22 N per token, chain, channel and state, fp32
// cores). Design: K4's (csrc/scan_g_bwd.cu), four launches counted as one
// call by the wrapper.
//   img_proj_bwd_kernel — K10's projection again (the same tiles,
//     tc::proj_tile: 3xTF32 at fp32 io, 1xTF32 at bf16), into the same
//     scratch P, so the streams K11 scans back are the bits K10 scanned and
//     checkpointed.
//   then the chunk backward of csrc/chunk_bwd.cuh over the four chains
//     (ImgBwdSrc): each 128-token chunk's adjoint from a zero exit adjoint,
//     a fixed-order carry pass, the emission, with h recomputed in every
//     32-token segment from K10's checkpoints. u and dy are read, du and
//     dd written, through the same pixel map, dir 1 reversed in place. Work
//     spreads over (chunk, 32-channel tile, chain, batch): 7,200 blocks at
//     trunk stage 0. d_state up to 256: the body walks state tiles of 16
//     inside the block (TILED), restaging B, C, A, the exit adjoints and
//     the checkpoints per tile and keeping each token's sum_n dh B and sum_n
//     dh A a h in the registers of the thread that owns it across the tiles
//     (a fixed order), so du and dd leave once; splitting the states in the
//     wrapper instead would write and re-read du and dd per slice.
//   It writes the direct du term as one plane per chain and dd, dB and dC
//   in image order per (dir, batch, layout), so K5 contracts them with x
//   itself (us = (x, x)); dB / dC as per-32-channel-block partials and dA /
//   dbias / dD as per-chunk partials, which the wrapper sums in a fixed
//   order. No atomics anywhere: a rerun gives the same bits.
//   bf16 io (as the TPU kernel's, pallas_scan_g.py:2393-2399): the operand
//   sources are templates over the io type, as K3 / K4's are
//   (csrc/scan_g_bwd.cu). x and dy are read as bf16 and widened in
//   registers; P, hck, the adjoints, the carries, every output (du4, dd,
//   the partials) and every sum stay fp32, and K5 takes x as its bf16
//   operand. At fp32 io the conversions are the identity: the same code,
//   the same bits.
//
// Both launch on the caller's stream, allocate nothing (scratch comes from
// the wrapper), and return cudaGetLastError(). Both take fp32 or bf16 io
// (fp32 state and arithmetic).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "chunk_bwd.cuh"
#include "chunk_fwd.cuh"
#include "tc_gemm.cuh"

namespace {

using chunk::from_f;
using chunk::to_f;

constexpr int kMaxState = 256;

constexpr int kErrStateWidth = 10001;
constexpr int kErrArguments = 10003;

// pixel of token t of a layout's sequence: hw row-major, wh column-major
__device__ __forceinline__ int pixel(int t, int layout, int H, int W) {
  return layout ? (t % H) * W + t / H : t;
}

// the pixel map of one layout as a row map (tc::proj_tile, ImgSrc)
struct PixelMap {
  int layout, H, W;
  __device__ __forceinline__ int operator()(int t) const {
    return pixel(t, layout, H, W);
  }
};

// the arguments both kernels refuse (the four chains of a batch fit the
// grid's z, the tokens an int)
bool bad_image(int batch, int H, int W, int dg, int N) {
  return batch <= 0 || H <= 0 || W <= 0 || dg <= 0 || N <= 0 ||
         batch > 65535 / 4 || (long long)H * W > 2147483647LL;
}

// ---------------------------------------------------------------- K10
// K10's operands for the chunk scan (csrc/chunk_fwd.cuh), G = 4 chains per
// image: x (batch, H, W, dg); P (batch, 4, L, dg + 2N) fp32 scratch, each
// chain's [dt | B | C] in its token order; y (4, batch, H, W, dg), one
// plane per chain in image order; hck (4, batch, n_ck, N, dg).
template <typename T>
struct ImgSrc : chunk::FwdArgs {
  const T* x;
  const T* wdt;  // (4, dg, dg)
  const T* wbc;  // (4, dg, 2N): [W_B | W_C]
  T* y;
  float* P;
  int batch, H, W;

  struct View {
    const T* x;
    T* y;
    const float* P;
    float* hck;
    PixelMap px;
    int dg, N;
    __device__ float u_at(int t, int e) const {
      return to_f(x[(size_t)px(t) * dg + e]);
    }
    __device__ float dt_at(int t, int e) const {
      return P[(size_t)t * (dg + 2 * N) + e];
    }
    __device__ float b_at(int t, int n) const {
      return P[(size_t)t * (dg + 2 * N) + dg + n];
    }
    __device__ float c_at(int t, int n) const {
      return P[(size_t)t * (dg + 2 * N) + dg + N + n];
    }
    __device__ void put_y(int t, int e, float v) const {
      y[(size_t)px(t) * dg + e] = from_f<T>(v);
    }
    __device__ void put_hck(int j, int n, int e, float v) const {
      hck[((size_t)j * N + n) * dg + e] = v;
    }
  };
  __device__ bool rev(int c) const { return c >> 1; }
  __device__ View view(int b, int c) const {
    const size_t bc = (size_t)b * 4 + c, cb = (size_t)c * batch + b;
    return View{x + (size_t)b * L * dg, y + cb * L * dg,
                P + bc * L * (dg + 2 * N),
                hck ? hck + cb * chunk::n_ck_of(L) * N * dg : nullptr,
                PixelMap{c & 1, H, W}, dg, N};
  }
};

// [dt | B | C] of chain c = blockIdx.z % 4 of image b = blockIdx.z / 4, a
// 64 x 64 tile of (token, column) per block, x's rows through the pixel map
template <typename T>
__device__ __forceinline__ void img_proj(const ImgSrc<T>& p) {
  const int c = blockIdx.z % 4, b = blockIdx.z / 4;
  const int dg = p.dg, N = p.N;
  tc::proj_tile<T>(p.x + (size_t)b * p.L * dg, p.wdt + (size_t)c * dg * dg,
                   p.wbc + (size_t)c * dg * 2 * N,
                   p.P + ((size_t)b * 4 + c) * p.L * (dg + 2 * N), p.L, dg,
                   N, blockIdx.x * tc::kBM, blockIdx.y,
                   PixelMap{c & 1, p.H, p.W});
}

template <typename T>
__global__ void __launch_bounds__(tc::kGemmThreads)
img_proj_kernel(const ImgSrc<T> p) {
  img_proj(p);
}

template <typename T, int NT, bool TILED>
int launch_img(const ImgSrc<T>& p, cudaStream_t stream) {
  const int chains = 4 * p.batch;
  img_proj_kernel<T><<<tc::proj_grid(p.L, p.dg, p.N, chains),
                        tc::kGemmThreads, tc::proj_smem<T>(), stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return chunk::launch_chunk_scan<ImgSrc<T>, NT, TILED>(p, chains, stream);
}

template <typename T>
int fwd_entry(const void* x, const void* wdt, const void* wbc,
              const float* A, const float* bias, const float* Dk, void* y4,
              float* P, float* hloc, float* sd, int n_chunk, float* hck,
              int nck, int batch, int H, int W, int dg, int N, int softplus,
              cudaStream_t stream) {
  if (bad_image(batch, H, W, dg, N)) return kErrArguments;
  if (N > kMaxState) return kErrStateWidth;
  const int L = H * W;
  if (n_chunk != (L + chunk::kChunk - 1) / chunk::kChunk ||
      (hck && nck != chunk::n_ck_of(L)))
    return kErrArguments;
  ImgSrc<T> p{};
  chunk::set_fwd_args(p, A, bias, Dk, hloc, sd, hck, 4, L, dg, N, softplus,
                      n_chunk);
  p.x = static_cast<const T*>(x);
  p.wdt = static_cast<const T*>(wdt);
  p.wbc = static_cast<const T*>(wbc);
  p.y = static_cast<T*>(y4);
  p.P = P;
  p.batch = batch;
  p.H = H;
  p.W = W;
  if (N <= 4) return launch_img<T, 4, false>(p, stream);
  if (N <= 8) return launch_img<T, 8, false>(p, stream);
  if (N <= 16) return launch_img<T, 16, false>(p, stream);
  return launch_img<T, 16, true>(p, stream);
}

// ---------------------------------------------------------------- K11
// K11a: K10's projection of the four chains (the same kernel body) into P
template <typename T>
__global__ void __launch_bounds__(tc::kGemmThreads)
img_proj_bwd_kernel(const ImgSrc<T> p) {
  img_proj(p);
}

// K11's operands for the chunk backward (csrc/chunk_bwd.cuh), G = 4 chains
// per image: x, dy (batch, H, W, dg); P as K10's (batch, 4, L, dg + 2N);
// du4 (4, batch, L, dg), the direct du term per chain in image order; dd
// (2, batch, 2, L, dg) and dBp, dCp (2, batch, nblk, 2, L, N) in image
// order, [dir, batch, (blk,) layout]; hck (4, batch, n_ck, N, dg) as K10
// wrote it. x and dy in the io type T, everything else fp32.
template <typename T>
struct ImgBwdSrc : chunk::BwdArgs {
  const T* x;
  const T* dy;
  const float* P;
  const float* hck;
  float* du4;
  float* dd;
  float* dBp;
  float* dCp;
  int batch, H, W, nblk;

  struct View {
    const T *x, *dy;
    const float *P, *hck;
    float *du, *dd, *dB, *dC;
    size_t blk_step;  // between two channel blocks' partials
    PixelMap px;
    int dg, N;
    __device__ float u_at(int t, int e) const {
      return to_f(x[(size_t)px(t) * dg + e]);
    }
    __device__ float dy_at(int t, int e) const {
      return to_f(dy[(size_t)px(t) * dg + e]);
    }
    __device__ float dt_at(int t, int e) const {
      return P[(size_t)t * (dg + 2 * N) + e];
    }
    __device__ float b_at(int t, int n) const {
      return P[(size_t)t * (dg + 2 * N) + dg + n];
    }
    __device__ float c_at(int t, int n) const {
      return P[(size_t)t * (dg + 2 * N) + dg + N + n];
    }
    __device__ void put_du(int t, int e, float v) const {
      du[(size_t)px(t) * dg + e] = v;
    }
    __device__ void put_dd(int t, int e, float v) const {
      dd[(size_t)px(t) * dg + e] = v;
    }
    __device__ void put_dbc(int blk, int t, int n, float vb, float vc) const {
      const size_t o = blk * blk_step + (size_t)px(t) * N + n;
      dB[o] = vb;
      dC[o] = vc;
    }
  };
  __device__ bool rev(int c) const { return c >> 1; }
  __device__ View view(int b, int c) const {
    const int dir = c >> 1, layout = c & 1;
    const size_t bc = (size_t)b * 4 + c, cb = (size_t)c * batch + b;
    const size_t db = (size_t)dir * batch + b;
    const size_t part = (db * nblk * 2 + layout) * L * N;
    return View{x + (size_t)b * L * dg,
                dy + (size_t)b * L * dg,
                P + bc * L * (dg + 2 * N),
                hck + cb * chunk::n_ck_of(L) * N * dg,
                du4 + cb * L * dg,
                dd + (db * 2 + layout) * L * dg,
                dBp + part,
                dCp + part,
                (size_t)2 * L * N,
                PixelMap{layout, H, W},
                dg,
                N};
  }
};

template <typename T>
int bwd_entry(const void* x, const void* wdt, const void* wbc, const float* A,
              const float* bias, const float* Dk, const float* hck,
              const void* dy, float* du4, float* P, float* dd, float* dA,
              float* dbias, float* dD, float* dBp, float* dCp, float* lam,
              float* sd, int n_chunk, int nck, int batch, int H, int W,
              int dg, int N, int softplus, cudaStream_t s) {
  if (bad_image(batch, H, W, dg, N)) return kErrArguments;
  if (N > kMaxState) return kErrStateWidth;
  const int L = H * W;
  if (n_chunk != (L + chunk::kChunk - 1) / chunk::kChunk ||
      nck != chunk::n_ck_of(L))
    return kErrArguments;
  ImgSrc<T> q{};
  chunk::set_fwd_args(q, A, bias, Dk, nullptr, nullptr, nullptr, 4, L, dg, N,
                      softplus, n_chunk);
  q.x = static_cast<const T*>(x);
  q.wdt = static_cast<const T*>(wdt);
  q.wbc = static_cast<const T*>(wbc);
  q.P = P;
  q.batch = batch;
  q.H = H;
  q.W = W;
  img_proj_bwd_kernel<T><<<tc::proj_grid(L, dg, N, 4 * batch),
                           tc::kGemmThreads, tc::proj_smem<T>(), s>>>(q);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ImgBwdSrc<T> p{};
  chunk::set_bwd_args(p, A, bias, Dk, lam, sd, dA, dbias, dD, 4, L, dg, N,
                      softplus, n_chunk);
  p.x = static_cast<const T*>(x);
  p.dy = static_cast<const T*>(dy);
  p.P = P;
  p.hck = hck;
  p.du4 = du4;
  p.dd = dd;
  p.dBp = dBp;
  p.dCp = dCp;
  p.batch = batch;
  p.H = H;
  p.W = W;
  p.nblk = (dg + chunk::kBwdChan - 1) / chunk::kBwdChan;
  const int chains = 4 * batch;
  if (N <= 4)
    return chunk::launch_chunk_bwd<ImgBwdSrc<T>, 4, false>(p, chains, s);
  if (N <= 8)
    return chunk::launch_chunk_bwd<ImgBwdSrc<T>, 8, false>(p, chains, s);
  if (N <= 16)
    return chunk::launch_chunk_bwd<ImgBwdSrc<T>, 16, false>(p, chains, s);
  return chunk::launch_chunk_bwd<ImgBwdSrc<T>, 16, true>(p, chains, s);
}

}  // namespace

extern "C" {

// K10. x: (batch, H, W, dg); wdt: (4, dg, dg); wbc: (4, dg, 2N) ([W_B |
// W_C]), all in the io type (bf16 when bf16, else fp32); A: (4, N, dg),
// bias, Dk: (4, dg) fp32, chain c = 2 dir + layout. y4: (4, batch, H, W,
// dg) in the io type, one plane per chain in image order. Scratch, fp32:
// P (batch, 4, H W, dg + 2N), hloc (batch, 4, n_chunk, N, dg), sd (batch,
// 4, n_chunk, dg) with n_chunk = ceil(H W / 128). hck, null or (4, batch,
// nck, N, dg) fp32 with nck = ceil(H W / 32), receives the state
// checkpoints.
int sigma_scan_img_fwd(const void* x, const void* wdt, const void* wbc,
                       const float* A, const float* bias, const float* Dk,
                       void* y4, float* P, float* hloc, float* sd,
                       int n_chunk, float* hck, int nck, int batch, int H,
                       int W, int dg, int N, int softplus, int bf16,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return fwd_entry<__nv_bfloat16>(x, wdt, wbc, A, bias, Dk, y4, P, hloc,
                                    sd, n_chunk, hck, nck, batch, H, W, dg,
                                    N, softplus, s);
  return fwd_entry<float>(x, wdt, wbc, A, bias, Dk, y4, P, hloc, sd,
                          n_chunk, hck, nck, batch, H, W, dg, N, softplus,
                          s);
}

// K11. x, wdt, wbc, A, bias, Dk as for K10, x, wdt and wbc in the io type;
// hck as K10 wrote it; dy: (batch, H, W, dg) in the io type. du4: (4,
// batch, H, W, dg), the direct du term per chain; dd: (2, batch, 2, H W,
// dg) and dBp, dCp: (2, batch, ceil(dg / 32), 2, H W, N) channel-block
// partials, image order, [dir, ., layout]; dA: (batch, 4, n_chunk, N, dg),
// dbias, dD: (batch, 4, n_chunk, dg) per-chunk partials; all outputs fp32.
// Scratch, fp32: P as for K10, lam (batch, 4, n_chunk, N, dg), sd (batch,
// 4, n_chunk, dg), n_chunk = ceil(H W / 128).
int sigma_scan_img_bwd(const void* x, const void* wdt, const void* wbc,
                       const float* A, const float* bias, const float* Dk,
                       const float* hck, const void* dy, float* du4,
                       float* P, float* dd, float* dA, float* dbias,
                       float* dD, float* dBp, float* dCp, float* lam,
                       float* sd, int n_chunk, int nck, int batch, int H,
                       int W, int dg, int N, int softplus, int bf16,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return bwd_entry<__nv_bfloat16>(x, wdt, wbc, A, bias, Dk, hck, dy, du4,
                                    P, dd, dA, dbias, dD, dBp, dCp, lam, sd,
                                    n_chunk, nck, batch, H, W, dg, N,
                                    softplus, s);
  return bwd_entry<float>(x, wdt, wbc, A, bias, Dk, hck, dy, du4, P, dd, dA,
                          dbias, dD, dBp, dCp, lam, sd, n_chunk, nck, batch,
                          H, W, dg, N, softplus, s);
}

const char* sigma_scan_img_error_string(int code) {
  switch (code) {
    case kErrStateWidth:
      return "d_state above 256 is not supported by the image scan kernels";
    case kErrArguments:
      return "invalid image scan arguments";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
