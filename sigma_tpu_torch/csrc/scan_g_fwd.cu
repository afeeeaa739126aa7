// Forward selective-scan kernels for Hopper (sm_90a), plain C interface
// for ctypes. Built by sigma_tpu_torch/ops/_build.py with nvcc.
//
// Replaces sigma_tpu/ops/pallas_scan_g.py::_fwd_kernel, reached through
// _fwd_call (streamed and fused-projection, n_u = 1) and _fwd_call_ml
// (fused-projection, n_u = 2), and, in the per-row layout,
// sigma_tpu/ops/pallas_scan_seq.py::_fwd_kernel. Semantics per chain g,
// channel e:
//     d_t = softplus(dt_t + bias_e)                 (softplus optional)
//     h_t = exp(d_t * A_e) * h_{t-1} + d_t * u_t * B_t      (h in R^N, fp32)
//     y_t = <C_t, h_t> + D_e * u_t (+ y_accum_t)
// walked first-to-last, or last-to-first in place for `reverse`.
//
// K1 scans on the chunk-parallel body of csrc/chunk_fwd.cuh (128-token
// chunks from a zero state, a fixed-order carry pass, the emission from the
// true carries; K10 in csrc/scan_img.cu runs the same body), K2 on the
// one-pass body of csrc/chain_fwd.cuh (the same chunks, scanned once, the
// carries chained in the walk's order). They differ in where dt, B and C
// come from:
//
// K1 — streamed: dt[b, g, t, e] and B / C[b, g, t, n] are tensors in device
//   memory in the io type (StreamSrc). Three launches, counted as one call
//   by the wrapper. Bound: device memory. Per token and channel it reads u
//   and dt and writes y (fp32: 12 bytes, plus 4 for y_accum), against ~9N
//   flops; the chunks spread the sequence over the card (7,200 blocks for
//   the per-row scan at sigma_tiny's trunk stage 0, where the sequential
//   design this replaces had 24 blocks of one thread per channel walking
//   19,200 tokens).
//
// K2 — fused projection: dt = u W_dt, B = u W_B and C = u W_C (under
//   swap_c, chain pair (2k, 2k+1) reads C projected from the partner's u
//   with the partner's W_C: CroMB), then the scan (ProjSrc). Two launches,
//   counted as one call by the wrapper:
//   K2a wg::proj_kernel (csrc/proj_wgmma.cuh) — [dt | B | C] for every
//     token, once per chain, on the warpgroup MMAs fed by TMA (3xTF32 at
//     fp32 io, bf16 products at bf16 io), into an fp32 stream P (batch, G,
//     L, dg + 2N) that the wrapper allocates, written once.
//   K2b chain::chain_scan_kernel (csrc/chain_fwd.cuh) — reads P once: one
//     exp per (token, channel, state), the carries chained chunk to chunk
//     in the walk's order, y and the checkpoints emitted in the same pass.
//   Why P and not a projection inside the scan's block: the one-pass body
//   keeps the carry's weights (4 x 16 values a lane) in registers, which
//   holds a block to 8 channels; a block that projected its own B and C
//   would redo those 2N columns once per 8 channels (24 times at dg 192),
//   where P costs one write and one read of dg + 2N fp32 values a token.
//   Bound: the scan's exps and fp32 operations (~9N per token, channel and
//   state, one pass) and P's traffic; the projection is 2 dg (dg + 2N)
//   flops per token and chain on the tensor cores.
//
// K1 and K2: io fp32 or bf16, state and arithmetic fp32, d_state <= 16 per
// launch (the entry points run wider states as slices). They launch on the
// caller's stream, allocate nothing (scratch comes from the wrapper), and
// return cudaGetLastError().
//
// State checkpoints for the backward kernels (csrc/scan_g_bwd.cu): given a
// non-null `hck`, (batch, G, n_ck, N, dg) fp32 with n_ck = ceil(L / kSeg),
// hck[j] is h as the walk enters checkpoint segment j (physical tokens
// [j*kSeg, (j+1)*kSeg)): the state before token j*kSeg forward, before its
// last token (or L - 1) reversed. Checkpointing is a template parameter
// (CK): a null `hck` (eval) launches the instantiation without it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "chain_fwd.cuh"
#include "chunk_fwd.cuh"
#include "proj_wgmma.cuh"

namespace {

using namespace chunk;  // kSeg, kChunk, FwdArgs, launch_chunk_scan, ...

constexpr int kMaxState = 16;  // the widest state tile, N per launch

constexpr int kErrStateWidth = 10001;
constexpr int kErrArguments = 10003;

// K1's operands: u, dt, y, yacc (batch, G, L, dg); Bm, Cm (batch, G, L, N)
template <typename T>
struct StreamSrc : FwdArgs {
  const T* u;
  const T* dt;
  const T* Bm;
  const T* Cm;
  const T* ya;  // may be null
  T* y;
  int reverse;

  struct View {
    const T *u, *dt, *Bm, *Cm, *ya;
    T* y;
    float* hck;
    int dg, N;
    __device__ float u_at(int t, int e) const {
      return to_f(u[(size_t)t * dg + e]);
    }
    __device__ float dt_at(int t, int e) const {
      return to_f(dt[(size_t)t * dg + e]);
    }
    __device__ float b_at(int t, int n) const {
      return to_f(Bm[(size_t)t * N + n]);
    }
    __device__ float c_at(int t, int n) const {
      return to_f(Cm[(size_t)t * N + n]);
    }
    __device__ void put_y(int t, int e, float v) const {
      const size_t o = (size_t)t * dg + e;
      if (ya) v += to_f(ya[o]);
      y[o] = from_f<T>(v);
    }
    __device__ void put_hck(int j, int n, int e, float v) const {
      hck[((size_t)j * N + n) * dg + e] = v;
    }
  };
  __device__ bool rev(int) const { return reverse; }
  __device__ View view(int b, int g) const {
    const size_t bg = (size_t)b * G + g;
    const size_t big = bg * L * dg, small = bg * L * N;
    return View{u + big, dt + big, Bm + small, Cm + small,
                ya ? ya + big : nullptr, y + big,
                hck ? hck + bg * n_ck_of(L) * N * dg : nullptr, dg, N};
  }
};

// K2's operands for the one-pass body (csrc/chain_fwd.cuh). n_u == 2:
// u[j] is layout j, (batch, L, dg), and chain g reads u[g]; n_u == 1: u[0]
// is (batch, G, L, dg). ya / y follow u; ya may be null. dt / B / C from
// the projected stream P, C from the partner chain's under swap_c.
template <typename T>
struct ProjSrc : chain::ChainArgs {
  const T* u[2];
  const T* ya[2];
  T* y[2];
  const float* P;  // (batch, G, L, dg + 2N): [dt | B | C] per token
  int n_u, reverse, swap_c;

  struct View {
    const T* u;
    const T* ya;
    T* y;
    const float* P;   // this chain's [dt | B | C] rows
    const float* Pc;  // the rows its C comes from
    float* hck;
    int dg, N;
    __device__ float u_at(int t, int e) const {
      return to_f(u[(size_t)t * dg + e]);
    }
    __device__ float dt_at(int t, int e) const {
      return P[(size_t)t * (dg + 2 * N) + e];
    }
    __device__ float b_at(int t, int n) const {
      return P[(size_t)t * (dg + 2 * N) + dg + n];
    }
    __device__ float c_at(int t, int n) const {
      return Pc[(size_t)t * (dg + 2 * N) + dg + N + n];
    }
    __device__ void put_y(int t, int e, float v) const {
      const size_t o = (size_t)t * dg + e;
      if (ya) v += to_f(ya[o]);
      y[o] = from_f<T>(v);
    }
    __device__ void put_hck(int j, int n, int e, float v) const {
      hck[((size_t)j * N + n) * dg + e] = v;
    }
  };
  __device__ __host__ size_t chain_offset(int b, int g) const {
    return n_u == 2 ? (size_t)b * L * dg : ((size_t)b * G + g) * L * dg;
  }
  __device__ bool rev(int) const { return reverse; }
  __device__ View view(int b, int g) const {
    const size_t bg = (size_t)b * G + g, off = chain_offset(b, g);
    const size_t rows = (size_t)L * (dg + 2 * N);
    const int j = n_u == 2 ? g : 0;
    const int gp = swap_c ? (g ^ 1) : g;
    return View{u[j] + off, ya[j] ? ya[j] + off : nullptr, y[j] + off,
                P + bg * rows, P + ((size_t)b * G + gp) * rows,
                hck ? hck + bg * n_ck_of(L) * N * dg : nullptr, dg, N};
  }
};

// K1: the chunk states, the carries, the emission
template <typename T, int NT>
int launch_stream(const StreamSrc<T>& p, int batch, cudaStream_t stream) {
  return launch_chunk_scan<StreamSrc<T>, NT, false>(p, batch * p.G, stream);
}

// K2's projection launches, told apart from K4's in a trace
struct ProjFwd {};

// K2: the projection, then the one-pass scan (flags and counter zeroed by
// the caller)
template <typename T, int NT>
int launch_proj(const ProjSrc<T>& p, const void* uk0, const void* uk1,
                const void* wdt, const void* wb, const void* wc, void* wt,
                int batch, int dgk, cudaStream_t stream) {
  const int code = wg::launch_proj<T, ProjFwd>(
      uk0, uk1, wdt, wb, wc, wt, const_cast<float*>(p.P), batch, p.G, p.L,
      p.dg, dgk, p.N, p.n_u, stream);
  if (code) return code;
  return chain::launch_chain_scan<ProjSrc<T>, NT>(p, batch * p.G, stream);
}

// the arguments every launch checks: positive sizes, batch * G chain
// instances within the grid, the scratch and checkpoint counts
bool bad_sizes(int batch, int G, int L, int dg, int N, int n_chunk,
               const float* hck, int nck) {
  return batch <= 0 || G <= 0 || L <= 0 || dg <= 0 || N <= 0 ||
         (size_t)batch * G > 65535 || n_chunk != (L + kChunk - 1) / kChunk ||
         (hck && nck != n_ck_of(L));
}

}  // namespace

extern "C" {

// u, dt, y, yacc: (batch, G, L, dg); Bm, Cm: (batch, G, L, N);
// A: (G, N, dg) fp32; bias, Dk: (G, dg) fp32. yacc may be null. Scratch,
// fp32: hloc (batch, G, n_chunk, N, dg), sd (batch, G, n_chunk, dg) with
// n_chunk = ceil(L / kChunk). hck, null or (batch, G, nck, N, dg) fp32 with
// nck = ceil(L / kSeg), receives the state checkpoints (nck is checked, so
// the caller's spacing must be kSeg).
int sigma_scan_fwd(const void* u, const void* dt, const float* A,
                   const void* Bm, const void* Cm, const float* bias,
                   const float* Dk, const void* yacc, void* y, float* hloc,
                   float* sd, int n_chunk, float* hck, int nck, int batch,
                   int G, int L, int dg, int N, int softplus, int reverse,
                   int bf16, void* stream) {
  if (bad_sizes(batch, G, L, dg, N, n_chunk, hck, nck)) return kErrArguments;
  if (N > kMaxState) return kErrStateWidth;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SIGMA_SCAN(T)                                                      \
  {                                                                        \
    StreamSrc<T> p{};                                                      \
    set_fwd_args(p, A, bias, Dk, hloc, sd, hck, G, L, dg, N, softplus,     \
                 n_chunk);                                                 \
    p.u = static_cast<const T*>(u);                                        \
    p.dt = static_cast<const T*>(dt);                                      \
    p.Bm = static_cast<const T*>(Bm);                                      \
    p.Cm = static_cast<const T*>(Cm);                                      \
    p.ya = static_cast<const T*>(yacc);                                    \
    p.y = static_cast<T*>(y);                                              \
    p.reverse = reverse;                                                   \
    if (N <= 4) return launch_stream<T, 4>(p, batch, s);                   \
    if (N <= 8) return launch_stream<T, 8>(p, batch, s);                   \
    return launch_stream<T, 16>(p, batch, s);                              \
  }
  if (bf16) SIGMA_SCAN(__nv_bfloat16)
  SIGMA_SCAN(float)
#undef SIGMA_SCAN
}

// n_u == 2: u0/u1, ya0/ya1, y0/y1 are the two layouts, (batch, L, dg) each,
// and G must be 2; n_u == 1: u0, ya0, y0 are (batch, G, L, dg). uk0 / uk1:
// the same u with rows of dgk >= dg elements (dg rounded up to 16 bytes,
// zero channels after dg; u itself where dgk == dg), 16-byte aligned, for
// the projection's TMA. wdt: (G, dg, dg), wb, wc: (G, dg, N), in the io
// type; wt: scratch for their prepared copy (wg::launch_proj). A: (G, N,
// dg), bias, Dk: (G, dg) fp32. swap_c needs G even (chain pairs 2k, 2k+1).
// Scratch: P (batch, G, L, dg + 2N) fp32; 64-bit words, zeroed here
// (n_words from gstate on): gstate (batch, G, n_group, N, dg), maps (batch
// G n_ctile n_chunk 2 NT kChan), then the int32 counter; NT = 4, 8 or 16
// (the least at least N), kChan chain::Tile<NT>'s, n_chunk = ceil(L /
// kChunk), n_group = ceil(n_chunk / chain::kGroup), n_ctile = ceil(dg /
// kChan). hck as for sigma_scan_fwd.
int sigma_scan_proj_fwd(const void* u0, const void* u1, const void* uk0,
                        const void* uk1, const void* wdt, const void* wb,
                        const void* wc, void* wt, const float* A,
                        const float* bias, const float* Dk, const void* ya0,
                        const void* ya1, void* y0, void* y1, float* P,
                        void* gstate, void* maps, int* counter, int n_words,
                        int n_chunk, float* hck, int nck, int batch, int G,
                        int L, int dg, int dgk, int N, int n_u, int softplus,
                        int reverse, int swap_c, int bf16, void* stream) {
  if (bad_sizes(batch, G, L, dg, N, n_chunk, hck, nck) ||
      (n_u != 1 && n_u != 2) || (n_u == 2 && G != 2) || (swap_c && G % 2))
    return kErrArguments;
  if (N > kMaxState) return kErrStateWidth;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(gstate, 0, sizeof(long long) * n_words, s);
  if (err != cudaSuccess) return static_cast<int>(err);
#define SIGMA_PROJ(T)                                                      \
  {                                                                        \
    ProjSrc<T> p{};                                                        \
    p.A = A;                                                               \
    p.bias = bias;                                                         \
    p.Dk = Dk;                                                             \
    p.gstate = static_cast<unsigned long long*>(gstate);                   \
    p.maps = static_cast<unsigned long long*>(maps);                       \
    p.counter = counter;                                                   \
    p.hck = hck;                                                           \
    p.G = G;                                                               \
    p.L = L;                                                               \
    p.dg = dg;                                                             \
    p.N = N;                                                               \
    p.softplus = softplus;                                                 \
    p.n_chunk = n_chunk;                                                   \
    p.u[0] = static_cast<const T*>(u0);                                    \
    p.u[1] = static_cast<const T*>(u1);                                    \
    p.ya[0] = static_cast<const T*>(ya0);                                  \
    p.ya[1] = static_cast<const T*>(ya1);                                  \
    p.y[0] = static_cast<T*>(y0);                                          \
    p.y[1] = static_cast<T*>(y1);                                          \
    p.P = P;                                                               \
    p.n_u = n_u;                                                           \
    p.reverse = reverse;                                                   \
    p.swap_c = swap_c;                                                     \
    if (N <= 4)                                                         \
      return launch_proj<T, 4>(p, uk0, uk1, wdt, wb, wc, wt, batch, dgk, s); \
    if (N <= 8)                                                         \
      return launch_proj<T, 8>(p, uk0, uk1, wdt, wb, wc, wt, batch, dgk, s); \
    return launch_proj<T, 16>(p, uk0, uk1, wdt, wb, wc, wt, batch, dgk, s); \
  }
  if (bf16) SIGMA_PROJ(__nv_bfloat16)
  SIGMA_PROJ(float)
#undef SIGMA_PROJ
}

const char* sigma_scan_error_string(int code) {
  switch (code) {
    case kErrStateWidth:
      return "d_state above 16 is not supported by the scan kernels";
    case kErrArguments:
      return "invalid scan arguments";
    case wg::kErrTensorMap:
      return "the projection's TMA descriptors could not be made";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
