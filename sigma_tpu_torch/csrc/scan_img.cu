// Image-layout SS2D scan for Hopper (sm_90a), plain C interface for ctypes.
// Built by sigma_tpu_torch/ops/_build.py with nvcc.
//
// Replaces sigma_tpu/ops/pallas_scan_g.py's image kernels, reached through
// selective_scan_ss2d_proj (:2371):
//   K10 — _fwd_kernel_img (:1856), via _fwd_call_img (:2217, pallas_call
//       :2249): img_proj_kernel, then the chunk scan of csrc/chunk_fwd.cuh;
//   K11 scan_img_bwd_kernel — _bwd_kernel_img (:1942), via _bwd_call_img
//       (:2270, pallas_call :2323); its weight gradients and du chain term
//       (the TPU body's dots :2086-2108) run on K5 (csrc/scan_g_bwd.cu).
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
// state, fp32 cores). Design: K2's (csrc/scan_g_fwd.cu), four launches
// counted as one call by the wrapper.
//   img_proj_kernel — [dt | B | C] once per (chain, batch) on the tensor
//     cores with K2a's tiles (tc::proj_tile; 3xTF32 at fp32 io, exact
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
// K11 walks each chain's segments against the forward's order from those
// checkpoints, re-projecting dt/B/C itself on the fp32 cores (the
// checkpoints come from K10's TF32 projections: fp32's accuracy at fp32
// io). A block of 288 threads owns one (32-channel tile, chain, batch):
// warps 0-7 (the producers) compute each segment's projections as a small
// GEMM, x rows of the segment (32 tokens) times [W_dt columns of the
// block's channels | W_B | W_C], with both operands streamed through
// shared memory in 32-deep k-tiles (double-buffered when shared memory
// allows), and add the dt bias and the softplus; warp 8 (the scanner) walks
// the recurrence, one lane per channel, with A prescaled by log2 e. Per
// segment and state tile (NT of 4, 8 or 16; the carry of every state in
// shared memory): the scanner recomputes h through the segment into shared
// memory; all 288 threads reduce dC_t = sum_e h_t dy_t over the block's
// channels; the scanner sweeps dh back through the segment, leaving dh d u
// in the slot of the h it no longer needs; all threads reduce those into
// dB. The channel sums cross blocks, so each block writes its own partial
// and the wrapper sums them, as K4 does; dA / dbias / dD are owned by one
// block per (chain, batch, channel) and the wrapper sums the batch. No
// atomics anywhere: a rerun gives the same bits. dd, dB and dC are written
// in image order per (dir, batch, layout), so K5 contracts them with x
// itself (us = (x, x)), and the direct du term goes to one plane per
// chain.
//
// Both launch on the caller's stream, allocate nothing (scratch comes from
// the wrapper), and return cudaGetLastError(). K10 takes fp32 or bf16 io
// (fp32 state and arithmetic); K11 is fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "chunk_fwd.cuh"
#include "tc_gemm.cuh"

namespace {

using chunk::from_f;
using chunk::softplus_f;
using chunk::to_f;

constexpr int kCh = 32;       // channels per block, one scanner lane each
constexpr int kTok = 32;      // tokens per tile = checkpoint segment
constexpr int kProj = 256;    // producer threads (warps 0-7)
constexpr int kThreads = kProj + 32;  // + the scanner warp (warp 8)
constexpr int kKt = 32;       // k-tile depth of the projection (== kCh)
constexpr int kLdU = kTok + 2;  // padded k-row of the staged x tile
constexpr int kCols = 64;     // projection columns per pass
constexpr int kLdH = kCh + 1;  // padded row of the per-token state store
constexpr int kMaxState = 256;
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
constexpr float kLn2 = 0.6931471805599453f;
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory per block
static_assert(kKt == kCh, "the x k-tile of the block's own channels is u");
static_assert(kTok == chunk::kSeg, "K11's segments are K10's checkpoints");
static_assert(kTok * kKt % kProj == 0 && kKt * kCols % kProj == 0 &&
                  kProj == 16 * (kTok / 2) && kCols == 16 * 4,
              "the producers stage whole tiles; 16 x 16 threads own 2 "
              "tokens x 4 columns each");

constexpr int kErrStateWidth = 10001;
constexpr int kErrSharedMemory = 10002;
constexpr int kErrArguments = 10003;

// the barrier of the producer warps alone (barrier 0 is __syncthreads)
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kProj) : "memory");
}

// NT consecutive floats of a 16-byte aligned shared-memory row
template <int NT>
__device__ __forceinline__ void load_row(const float* src, float (&dst)[NT]) {
#pragma unroll
  for (int n = 0; n < NT; n += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + n);
    dst[n] = v.x;
    dst[n + 1] = v.y;
    dst[n + 2] = v.z;
    dst[n + 3] = v.w;
  }
}

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
__global__ void __launch_bounds__(tc::kGemmThreads)
img_proj_kernel(const ImgSrc<T> p) {
  const int c = blockIdx.z % 4, b = blockIdx.z / 4;
  const int dg = p.dg, N = p.N;
  tc::proj_tile<T>(p.x + (size_t)b * p.L * dg, p.wdt + (size_t)c * dg * dg,
                   p.wbc + (size_t)c * dg * 2 * N,
                   p.P + ((size_t)b * 4 + c) * p.L * (dg + 2 * N), p.L, dg,
                   N, blockIdx.x * tc::kBM, blockIdx.y,
                   PixelMap{c & 1, p.H, p.W});
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
  if (batch <= 0 || H <= 0 || W <= 0 || dg <= 0 || N <= 0 ||
      batch > 65535 / 4 || (long long)H * W > 2147483647LL)
    return kErrArguments;
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

// K11's arguments
struct ImgArgs {
  const float* x;    // (batch, H, W, dg)
  const float* wdt;  // (4, dg, dg), chain c = 2 dir + layout
  const float* wb;   // (4, dg, N)
  const float* wc;   // (4, dg, N)
  const float* A;    // (4, N, dg)
  const float* bias;  // (4, dg)
  const float* Dk;   // (4, dg)
  float* hck;        // (4, batch, nck, N, dg): K10 writes, K11 reads
  const float* dy;   // (batch, H, W, dg)
  float* du;         // (4, batch, H, W, dg) direct term per chain
  float* dd;         // (2, batch, 2, H*W, dg) raw-dt cotangent
  float* dA;         // (4, batch, N, dg)
  float* dbias;      // (4, batch, dg)
  float* dD;         // (4, batch, dg)
  float* dBp;        // (2, batch, nblk, 2, H*W, N) channel-tile partials
  float* dCp;        // the same
  int batch, H, W, L, dg, N, NP, ldp, nck, nblk, nbuf, softplus;
};

// Projection of one tile, run by the kProj producer threads: for its tl
// tokens from t0 of the chain's sequence, P[t][j] = x_t [W_dt[:, e0:e0+32]
// | W_B | W_C] (columns [0, 32) dt of the block's channels, [32, 32 + NP)
// B and [32 + NP, 32 + 2 NP) C, states past N zero) and us[t][c] = x_t of
// channel e0 + c; the dt columns leave as the effective delta d =
// softplus(dt + bias) (the bias and softplus as the chain asks). Rows past
// tl are zero. Steps run over (column pass of
// kCols, k-tile of kKt); each step's x and W tiles are loaded into
// registers while the previous step's are multiplied, so a step waits for
// one round trip to device memory, not one per element, and the x row
// offsets and W column sources are computed once per tile and pass. The
// x tile is staged k-major (Uk[k][t]); thread (ty, tx) owns tokens 2 ty,
// 2 ty + 1 and columns 4 tx .. 4 tx + 3 of the pass: one float2 and one
// float4 read of shared memory per 8 multiply-adds.
__device__ __forceinline__ void project_tile(const ImgArgs& p,
                                             const float* x_b,
                                             const float* wdt_c,
                                             const float* wb_c,
                                             const float* wc_c,
                                             const float* bias_c, int layout,
                                             int e0, int t0, int tl,
                                             float* Uk, float* Wk, float* P,
                                             float* us) {
  constexpr int kRu = kTok * kKt / kProj;   // x elements per thread
  constexpr int kRw = kKt * kCols / kProj;  // W elements per thread
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int dg = p.dg, N = p.N, NP = p.NP;
  const int J = kCh + 2 * NP;
  const int nk = (dg + kKt - 1) / kKt;
  const int nsteps = nk * ((J + kCols - 1) / kCols);
  // this thread stages x element (token tid / kKt + r kProj / kKt, k tid %
  // kKt) and W element (k tid / kCols + r kProj / kCols, column tid % kCols)
  const int kx = tid % kKt, kw = tid / kCols, jw = tid % kCols;
  long long xoff[kRu];
#pragma unroll
  for (int r = 0; r < kRu; ++r) {
    const int t = tid / kKt + r * (kProj / kKt);
    xoff[r] = t < tl ? (long long)pixel(t0 + t, layout, p.H, p.W) * dg : -1;
  }
  float ru[kRu], rw[kRw];
  auto load = [&](int step) {
    const int j0 = step / nk * kCols, k0 = step % nk * kKt;
#pragma unroll
    for (int r = 0; r < kRu; ++r)
      ru[r] = xoff[r] >= 0 && k0 + kx < dg ? x_b[xoff[r] + k0 + kx] : 0.f;
    const int j = j0 + jw;
    // W column j of this pass, rows strided by ld
    const float* src = nullptr;
    int ld = 0;
    if (j < kCh && e0 + j < dg) {
      src = wdt_c + e0 + j;
      ld = dg;
    } else if (j >= kCh && j < kCh + N) {
      src = wb_c + (j - kCh);
      ld = N;
    } else if (j >= kCh + NP && j < kCh + NP + N) {
      src = wc_c + (j - kCh - NP);
      ld = N;
    }
#pragma unroll
    for (int r = 0; r < kRw; ++r) {
      const int d = k0 + kw + r * (kProj / kCols);
      rw[r] = src && d < dg ? src[(size_t)d * ld] : 0.f;
    }
  };
  load(0);
  float acc[2][4] = {};
  for (int step = 0; step < nsteps; ++step) {
    const int j0 = step / nk * kCols, k0 = step % nk * kKt;
#pragma unroll
    for (int r = 0; r < kRu; ++r)
      Uk[kx * kLdU + tid / kKt + r * (kProj / kKt)] = ru[r];
#pragma unroll
    for (int r = 0; r < kRw; ++r) Wk[tid + r * kProj] = rw[r];
    producer_sync();
    if (step + 1 < nsteps) load(step + 1);
    if (j0 == 0 && k0 == e0)
      for (int i = tid; i < kTok * kCh; i += kProj)
        us[i] = Uk[(i % kCh) * kLdU + i / kCh];
#pragma unroll 8
    for (int k = 0; k < kKt; ++k) {
      const float2 a = *reinterpret_cast<const float2*>(Uk + k * kLdU +
                                                        2 * ty);
      const float4 w = *reinterpret_cast<const float4*>(Wk + k * kCols +
                                                        4 * tx);
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[0][c] = fmaf(a.x, wv[c], acc[0][c]);
        acc[1][c] = fmaf(a.y, wv[c], acc[1][c]);
      }
    }
    if (k0 + kKt >= dg) {  // the pass is complete
      const int j = j0 + 4 * tx;
      if (j < kCh) {  // dt columns: the effective delta
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float b = e0 + j + c < dg ? bias_c[e0 + j + c] : 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            acc[r][c] += b;
            if (p.softplus) acc[r][c] = softplus_f(acc[r][c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (j < J)
          *reinterpret_cast<float4*>(P + (2 * ty + r) * p.ldp + j) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      }
    }
    producer_sync();
  }
}

// ---------------------------------------------------------------- K11
template <int NT>
__global__ void __launch_bounds__(kThreads)
scan_img_bwd_kernel(const ImgArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int dg = p.dg, N = p.N, NP = p.NP, L = p.L, ldp = p.ldp;
  const int nbuf = p.nbuf;
  // nbuf buffers, each kTok x ldp projections, kTok x kCh u, kTok x kCh dy
  // of the block's channels
  const int bufsz = kTok * (ldp + 2 * kCh);
  float* Uk = smem + nbuf * bufsz;        // kKt x kLdU
  float* Wk = Uk + kKt * kLdU;            // kKt x kCols
  float* hs = Wk + kKt * kCols;           // (kTok NT) x kLdH
  float* dhc = hs + kTok * NT * kLdH;     // NP x kCh: dh carry
  float* sbs = dhc + NP * kCh;            // kTok x kCh: sum_n dh B
  float* sas = sbs + kTok * kCh;          // kTok x kCh: sum_n dh A a h

  const int blk = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int dir = c >> 1, layout = c & 1;
  const int e0 = blk * kCh;
  const int nch = min(kCh, dg - e0);
  const float* x_b = p.x + (size_t)b * L * dg;
  const float* dy_b = p.dy + (size_t)b * L * dg;
  const float* wdt_c = p.wdt + (size_t)c * dg * dg;
  const float* wb_c = p.wb + (size_t)c * dg * N;
  const float* wc_c = p.wc + (size_t)c * dg * N;
  const float* bias_c = p.bias + (size_t)c * dg;
  const int nseg = (L + kTok - 1) / kTok;
  const bool producer = threadIdx.x < kProj;
  const bool scanner = !producer;
  const int lane = threadIdx.x - kProj;
  const int e = e0 + lane;
  const bool active = scanner && e < dg;
  const int ec = active ? e : e0;

  // segments against the forward's walk
  auto seg_of = [&](int it) { return dir ? it : nseg - 1 - it; };
  auto stage = [&](int it, int buf) {
    const int t0 = seg_of(it) * kTok;
    const int tl = min(kTok, L - t0);
    float* P = smem + buf * bufsz;
    project_tile(p, x_b, wdt_c, wb_c, wc_c, bias_c, layout, e0, t0,
                        tl, Uk, Wk, P, P + kTok * ldp);
    float* dys = P + kTok * (ldp + kCh);
    for (int i = threadIdx.x; i < kTok * kCh; i += kProj) {
      const int t = i / kCh, cc = i % kCh;
      dys[i] =
          t < tl && cc < nch
              ? dy_b[(size_t)pixel(t0 + t, layout, p.H, p.W) * dg + e0 + cc]
              : 0.f;
    }
  };

  if (producer) {
    if (nbuf == 2) stage(0, 0);
  } else {
    for (int i = lane; i < NP * kCh; i += 32) dhc[i] = 0.f;
  }
  __syncthreads();

  const float* A_c = p.A + (size_t)c * N * dg;
  const float* hck_c = p.hck + ((size_t)c * p.batch + b) * p.nck * N * dg;
  const size_t own = (size_t)c * p.batch + b;  // (chain, batch) slot
  float* du_c = p.du + own * L * dg;
  float* dd_c = p.dd + (((size_t)dir * p.batch + b) * 2 + layout) * L * dg;
  float* dA_c = p.dA + own * N * dg;
  const size_t part = (((size_t)dir * p.batch + b) * p.nblk + blk) * 2 +
                      layout;
  float* dB_c = p.dBp + part * L * N;
  float* dC_c = p.dCp + part * L * N;
  const float d_e = scanner ? p.Dk[(size_t)c * dg + ec] : 0.f;
  float dbias_acc = 0.f, dD_acc = 0.f;

  for (int it = 0; it < nseg; ++it) {
    const int j = seg_of(it);
    const int t0 = j * kTok;
    const int sl = min(kTok, L - t0);
    int buf = 0;
    if (nbuf == 1) {
      if (producer) stage(it, 0);
      __syncthreads();
    } else {
      buf = it & 1;
    }
    const float* P = smem + buf * bufsz;
    const float* us = P + kTok * ldp;
    const float* dys = us + kTok * kCh;

    for (int s0 = 0; s0 < NP; s0 += NT) {
      const bool last = s0 + NT >= NP;
      float Av[NT], h0[NT];  // Av: A log2 e
      // ---- recompute h through the segment from its checkpoint (the
      // producers project the next segment meanwhile): hs[k] = h after
      // physical token t0 + k
      if (scanner) {
        float h[NT];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const bool ok = s0 + n < N;
          Av[n] = ok ? A_c[(size_t)(s0 + n) * dg + ec] * kLog2e : 0.f;
          h0[n] = ok ? hck_c[((size_t)j * N + s0 + n) * dg + ec] : 0.f;
          h[n] = h0[n];
        }
#pragma unroll 4
        for (int i = 0; i < sl; ++i) {
          const int k = dir ? sl - 1 - i : i;
          const float* Pk = P + k * ldp;
          const float dv = Pk[lane];
          const float du = dv * us[k * kCh + lane];
          float Bv[NT];
          load_row<NT>(Pk + kCh + s0, Bv);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            h[n] = fmaf(exp2f(dv * Av[n]), h[n], du * Bv[n]);
            hs[(k * NT + n) * kLdH + lane] = h[n];
          }
        }
      } else if (nbuf == 2 && s0 == 0 && it + 1 < nseg) {
        stage(it + 1, buf ^ 1);
      }
      __syncthreads();

      // ---- dC_t = sum over the block's channels of h_t dy_t
      for (int o = threadIdx.x; o < sl * NT; o += kThreads) {
        const int k = o / NT, n = o % NT;
        if (s0 + n >= N) continue;
        const float* hr = hs + (size_t)(k * NT + n) * kLdH;
        const float* dr = dys + k * kCh;
        float s = 0.f;
        for (int cc = 0; cc < nch; ++cc) s = fmaf(hr[cc], dr[cc], s);
        const int px = pixel(t0 + k, layout, p.H, p.W);
        dC_c[(size_t)px * N + s0 + n] = s;
      }
      __syncthreads();

      // ---- the dh sweep against the walk; hs[k] becomes dh_t d_t u_t
      if (scanner) {
        float dh[NT], dA_acc[NT];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          dh[n] = dhc[(s0 + n) * kCh + lane];
          dA_acc[n] = 0.f;
        }
        for (int i = 0; i < sl; ++i) {
          const int k = dir ? i : sl - 1 - i;
          const bool first = dir ? k == sl - 1 : k == 0;
          const int kp = dir ? k + 1 : k - 1;  // the previous token walked
          const float* Pk = P + k * ldp;
          const float dv = Pk[lane];
          const float uv = us[k * kCh + lane];
          const float dyv = dys[k * kCh + lane];
          const float dvu = dv * uv;
          float Bv[NT], Cv[NT];
          load_row<NT>(Pk + kCh + s0, Bv);
          load_row<NT>(Pk + kCh + NP + s0, Cv);
          float sb = 0.f, sa = 0.f;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float hp = first ? h0[n] : hs[(kp * NT + n) * kLdH + lane];
            const float a = exp2f(dv * Av[n]);
            const float ahp = a * hp;
            dh[n] = fmaf(Cv[n], dyv, dh[n]);
            sb = fmaf(dh[n], Bv[n], sb);
            sa = fmaf(dh[n] * Av[n], ahp, sa);
            dA_acc[n] = fmaf(dh[n] * ahp, dv, dA_acc[n]);
            hs[(k * NT + n) * kLdH + lane] = dh[n] * dvu;
            dh[n] *= a;
          }
          sa *= kLn2;  // the sum of dh A a h
          if (s0 > 0) {
            sb += sbs[k * kCh + lane];
            sa += sas[k * kCh + lane];
          }
          if (!last) {
            sbs[k * kCh + lane] = sb;
            sas[k * kCh + lane] = sa;
          } else if (active) {
            const float ddv = fmaf(uv, sb, sa);
            // softplus' derivative: sigmoid(pre) = 1 - exp(-d)
            const float ddr = p.softplus ? ddv * -expm1f(-dv) : ddv;
            dbias_acc += ddr;
            dD_acc = fmaf(dyv, uv, dD_acc);
            const size_t off =
                (size_t)pixel(t0 + k, layout, p.H, p.W) * dg + e;
            du_c[off] = fmaf(dv, sb, d_e * dyv);
            dd_c[off] = ddr;
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          dhc[(s0 + n) * kCh + lane] = dh[n];
          if (active && s0 + n < N) {
            float* dst = dA_c + (size_t)(s0 + n) * dg + e;
            *dst = it == 0 ? dA_acc[n] : *dst + dA_acc[n];
          }
        }
      }
      __syncthreads();

      // ---- dB_t = sum over the block's channels of dh_t d_t u_t
      for (int o = threadIdx.x; o < sl * NT; o += kThreads) {
        const int k = o / NT, n = o % NT;
        if (s0 + n >= N) continue;
        const float* hr = hs + (size_t)(k * NT + n) * kLdH;
        float s = 0.f;
        for (int cc = 0; cc < nch; ++cc) s += hr[cc];
        const int px = pixel(t0 + k, layout, p.H, p.W);
        dB_c[(size_t)px * N + s0 + n] = s;
      }
      __syncthreads();  // hs is free for the next state tile or segment
    }
  }

  if (active) {
    p.dbias[own * dg + e] = dbias_acc;
    p.dD[own * dg + e] = dD_acc;
  }
}

// columns of the projection buffer rounded to 32 banks plus 16, so the
// producers' two token rows of a warp write distinct banks
int proj_ld(int NP) { return (kCh + 2 * NP + 31) / 32 * 32 + 16; }

size_t bwd_smem(int NP, int NT, int nbuf) {
  const int ldp = proj_ld(NP);
  return sizeof(float) * ((size_t)nbuf * kTok * (ldp + 2 * kCh) +
                          (size_t)kKt * kLdU + (size_t)kKt * kCols +
                          (size_t)kTok * NT * kLdH + (size_t)NP * kCh +
                          2 * (size_t)kTok * kCh);
}

int fill(ImgArgs& p, int batch, int H, int W, int dg, int N, int nck,
         int softplus, int NT) {
  if (batch <= 0 || H <= 0 || W <= 0 || dg <= 0 || N <= 0 ||
      batch > 65535 || (long long)H * W > 2147483647LL)
    return kErrArguments;
  if (N > kMaxState) return kErrStateWidth;
  p.batch = batch;
  p.H = H;
  p.W = W;
  p.L = H * W;
  p.dg = dg;
  p.N = N;
  p.NP = (N + NT - 1) / NT * NT;
  p.ldp = proj_ld(p.NP);
  p.nblk = (dg + kCh - 1) / kCh;
  p.softplus = softplus;
  if (nck != (p.L + kTok - 1) / kTok) return kErrArguments;
  p.nck = nck;
  return 0;
}

int state_tile(int N) { return N <= 4 ? 4 : N <= 8 ? 8 : 16; }

template <int NT>
int launch_bwd(ImgArgs p, cudaStream_t stream) {
  p.nbuf = 2;
  if (bwd_smem(p.NP, NT, 2) > kMaxSmem) p.nbuf = 1;
  const size_t smem = bwd_smem(p.NP, NT, p.nbuf);
  if (smem > kMaxSmem) return kErrSharedMemory;
  cudaError_t err = cudaFuncSetAttribute(
      scan_img_bwd_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.nblk, 4, p.batch);
  scan_img_bwd_kernel<NT><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
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

// K11, fp32. x, wdt, wb, wc, A, bias, Dk as for K10; hck as K10 wrote it;
// dy: (batch, H, W, dg). du4: (4, batch, H, W, dg), the direct du term per
// chain; dd: (2, batch, 2, H W, dg) and dBp, dCp: (2, batch, ceil(dg / 32),
// 2, H W, N) channel-tile partials, image order, [dir, ., layout]; dA:
// (4, batch, N, dg); dbias, dD: (4, batch, dg).
int sigma_scan_img_bwd(const float* x, const float* wdt, const float* wb,
                       const float* wc, const float* A, const float* bias,
                       const float* Dk, const float* hck, const float* dy,
                       float* du4, float* dd, float* dA, float* dbias,
                       float* dD, float* dBp, float* dCp, int nck, int batch,
                       int H, int W, int dg, int N, int softplus,
                       void* stream) {
  const int NT = state_tile(N);
  ImgArgs p = {};
  const int code = fill(p, batch, H, W, dg, N, nck, softplus, NT);
  if (code) return code;
  p.x = x;
  p.wdt = wdt;
  p.wb = wb;
  p.wc = wc;
  p.A = A;
  p.bias = bias;
  p.Dk = Dk;
  p.hck = const_cast<float*>(hck);
  p.dy = dy;
  p.du = du4;
  p.dd = dd;
  p.dA = dA;
  p.dbias = dbias;
  p.dD = dD;
  p.dBp = dBp;
  p.dCp = dCp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (NT == 4) return launch_bwd<4>(p, s);
  if (NT == 8) return launch_bwd<8>(p, s);
  return launch_bwd<16>(p, s);
}

const char* sigma_scan_img_error_string(int code) {
  switch (code) {
    case kErrStateWidth:
      return "d_state above 256 is not supported by the image scan kernels";
    case kErrSharedMemory:
      return "the image scan tiles do not fit in shared memory";
    case kErrArguments:
      return "invalid image scan arguments";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
