// Channel-first chunked selective scan for Hopper (sm_90a), fp32, plain C
// interface for ctypes. Built by sigma_tpu_torch/ops/_build.py with nvcc.
//
// Replaces the core of selective_scan(backend="pallas"):
//   K8 — sigma_tpu/ops/pallas_scan.py::_fwd_kernel (:41, pallas_call :94 in
//      _fwd_call): the chunk scan of csrc/chunk_fwd.cuh (CfSrc);
//   K9 — sigma_tpu/ops/pallas_scan_bwd.py::_bwd_kernel (:49, pallas_call
//      :176 in selective_scan_pallas_bwd): the chunk backward of
//      csrc/chunk_bwd.cuh (CfBwdSrc).
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
// the reference's (G dg, N) layout (a_at). With a gradient, the source
// keeps every 32-token checkpoint of the body for K9, in the layout K3
// reads: hck (rows, n_ck, N, dg).
//
// K9. Bound: device memory. It reads u, d, dy and writes du, dd (20 bytes
// per token and channel), reads B, C and writes dB, dC per row, and reads
// the checkpoints (at stage 0 about 0.69 GB, 0.21 ms at 3.35 TB/s), against
// 22N flops. Design: the three passes of the chunk backward K3, K4 and
// K11 run (csrc/chunk_bwd.cuh) over a channel-first source (CfBwdSrc):
// each 128-token chunk's adjoint from a zero exit adjoint, the fixed-order
// carry pass against the walk, then the emission, which recomputes h in
// every 32-token segment from K8's checkpoints and forms every output.
// The grid is (chunk, 32 channels, row): 7,200 blocks at stage 0, where
// the sequential design it replaces ran 192 blocks, each walking the 75
// chunks of its rows one after another. The source is token-major: a lane
// holds 4 consecutive tokens of a channel, so u, d and dy go from device
// memory straight into its registers and du, dd straight back, 16 bytes
// per lane, with no staging; B, C and the dB / dC partials move as runs
// of the chunk's tokens per state. The registers those three take come
// from the thread's sums over the states, kept in its own slots of shared
// memory (the emission's shared memory at 16 states: 83 KB, where the
// staged body takes 114). Then the shuffles' latency binds, so the body's
// token-major path also reduces many terms over the lanes at once (its
// local pass composes all the tile's states in one exchange, the
// emission sums a group's dA terms so). The emission keeps 2 blocks of
// 256 threads a SM (16 of 64 warps: 128 registers a thread); at 16
// states ptxas reports 156 bytes of spill (336 TILED). dB / dC: one
// partial per 32-channel block, (ceil(dg / 32), rows, N, L); dA: one per
// chunk, (rows, n_chunk, N, dg); the caller sums both in a fixed order, so
// a rerun gives the same bits. d_state up to 256 through the body's state
// tiles (TILED).
//
// Both launch on the caller's stream, allocate nothing, and return
// cudaGetLastError(). Ragged chunks and channel blocks are masked: a token
// past L has d = 0 (a = 1, b = 0) and is not written.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "chunk_bwd.cuh"
#include "chunk_fwd.cuh"

namespace {

constexpr int kMaxState = 256;

constexpr int kErrStateWidth = 10001;
constexpr int kErrArguments = 10003;

// ---------------------------------------------------------------- K8
// K8's operands for the chunk scan (csrc/chunk_fwd.cuh): u, d, y (rows, dg,
// L) and Bm, Cm (rows, N, L), row r = b G + g; hck null or (rows, n_ck, N,
// dg); A (G dg, N). The body's bias and D are null: the caller applies
// them.
struct CfSrc : chunk::FwdArgs {
  static constexpr bool kTokenMajor = true;
  const float* u;
  const float* d;
  const float* Bm;
  const float* Cm;
  float* y;

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
    __device__ void put_hck(int j, int n, int e, float v) const {
      hck[((size_t)j * N + n) * dg + e] = v;
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
                hck ? hck + r * chunk::n_ck_of(L) * N * dg : nullptr, L, dg,
                N};
  }
};

// ---------------------------------------------------------------- K9
// K9's operands for the chunk backward (csrc/chunk_bwd.cuh), token-major:
// u, d, dy, du, dd (rows, dg, L); Bm, Cm (rows, N, L); hck (rows, n_ck, N,
// dg) as K8 wrote it; dBp, dCp (ceil(dg / 32), rows, N, L); A (G dg, N).
// d is the effective delta: bias, softplus and D stay with the caller.
struct CfBwdSrc : chunk::BwdArgs {
  static constexpr bool kTokenMajor = true;
  const float* u;
  const float* d;
  const float* dy;
  const float* Bm;
  const float* Cm;
  const float* hck;
  float* du;
  float* dd;
  float* dBp;
  float* dCp;
  int rows;
  bool vec;  // u, d, dy, du, dd 16-byte aligned and L % 4 == 0

  struct View {
    const float *u, *d, *dy, *Bm, *Cm, *hck;
    float *du, *dd, *dB, *dC;
    size_t blk_step;  // between two channel blocks' partials
    int L;
    bool vec;
    __device__ const float* u_run(int e) const { return u + (size_t)e * L; }
    __device__ const float* dt_run(int e) const { return d + (size_t)e * L; }
    __device__ const float* dy_run(int e) const {
      return dy + (size_t)e * L;
    }
    __device__ float* du_run(int e) const { return du + (size_t)e * L; }
    __device__ float* dd_run(int e) const { return dd + (size_t)e * L; }
    __device__ float b_at(int t, int n) const {
      return Bm[(size_t)n * L + t];
    }
    __device__ float c_at(int t, int n) const {
      return Cm[(size_t)n * L + t];
    }
    __device__ void put_dbc(int blk, int t, int n, float vb, float vc) const {
      const size_t o = blk * blk_step + (size_t)n * L + t;
      dB[o] = vb;
      dC[o] = vc;
    }
  };
  __device__ float a_at(int g, int n, int e) const {
    return A[((size_t)g * dg + e) * N + n];
  }
  __device__ bool rev(int) const { return false; }
  __device__ View view(int b, int g) const {
    const size_t r = (size_t)b * G + g, ch = r * dg * L, st = r * N * L;
    return View{u + ch,
                d + ch,
                dy + ch,
                Bm + st,
                Cm + st,
                hck + r * chunk::n_ck_of(L) * N * dg,
                du + ch,
                dd + ch,
                dBp + st,
                dCp + st,
                (size_t)rows * N * L,
                L,
                vec};
  }
};

bool aligned16(const void* q) {
  return reinterpret_cast<std::uintptr_t>(q) % 16 == 0;
}

// the rows fit the grid, the checkpoints and the chunk scratch have the
// bodies' spacing
bool bad_args(int rows, int G, int dg, int L, int N, int nck, int n_chunk) {
  return rows <= 0 || G <= 0 || rows % G || rows > 65535 || dg <= 0 ||
         L <= 0 || N <= 0 || nck != chunk::n_ck_of(L) ||
         n_chunk != (L + chunk::kChunk - 1) / chunk::kChunk;
}

}  // namespace

extern "C" {

// u, d, y: (rows, dg, L) with rows = batch * G, row r of group r % G;
// A: (G * dg, N); Bm, Cm: (rows, N, L); all fp32. Scratch hloc (rows,
// n_chunk, N, dg), sd (rows, n_chunk, dg), n_chunk = ceil(L / 128). hck,
// null or (rows, nck, N, dg) with nck = ceil(L / 32), receives h as the
// scan enters every 32-token segment.
int sigma_scan_cf_fwd(const float* u, const float* d, const float* A,
                      const float* Bm, const float* Cm, float* y, float* hloc,
                      float* sd, int n_chunk, float* hck, int rows, int G,
                      int dg, int L, int N, int nck, void* stream) {
  if (bad_args(rows, G, dg, L, N, nck, n_chunk)) return kErrArguments;
  if (N > kMaxState) return kErrStateWidth;
  CfSrc p{};
  chunk::set_fwd_args(p, A, nullptr, nullptr, hloc, sd, hck, G, L, dg, N, 0,
                      n_chunk);
  p.u = u;
  p.d = d;
  p.Bm = Bm;
  p.Cm = Cm;
  p.y = y;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 4) return chunk::launch_chunk_scan<CfSrc, 4, false>(p, rows, s);
  if (N <= 8) return chunk::launch_chunk_scan<CfSrc, 8, false>(p, rows, s);
  if (N <= 16) return chunk::launch_chunk_scan<CfSrc, 16, false>(p, rows, s);
  return chunk::launch_chunk_scan<CfSrc, 16, true>(p, rows, s);
}

// Operands as for sigma_scan_cf_fwd, hck as it wrote it, dy like y.
// du, dd: (rows, dg, L); dA: (rows, n_chunk, N, dg) per-chunk partials;
// dBp, dCp: (ceil(dg / 32), rows, N, L) per-channel-block partials (the
// caller sums both); scratch lam (rows, n_chunk, N, dg), sd (rows,
// n_chunk, dg).
int sigma_scan_cf_bwd(const float* u, const float* d, const float* A,
                      const float* Bm, const float* Cm, const float* hck,
                      const float* dy, float* du, float* dd, float* dA,
                      float* dBp, float* dCp, float* lam, float* sd,
                      int n_chunk, int rows, int G, int dg, int L, int N,
                      int nck, void* stream) {
  if (bad_args(rows, G, dg, L, N, nck, n_chunk)) return kErrArguments;
  if (N > kMaxState) return kErrStateWidth;
  CfBwdSrc p{};
  chunk::set_bwd_args(p, A, nullptr, nullptr, lam, sd, dA, nullptr, nullptr,
                      G, L, dg, N, 0, n_chunk);
  p.u = u;
  p.d = d;
  p.dy = dy;
  p.Bm = Bm;
  p.Cm = Cm;
  p.hck = hck;
  p.du = du;
  p.dd = dd;
  p.dBp = dBp;
  p.dCp = dCp;
  p.rows = rows;
  p.vec = L % chunk::kItems == 0 && aligned16(u) && aligned16(d) &&
          aligned16(dy) && aligned16(du) && aligned16(dd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 4) return chunk::launch_chunk_bwd<CfBwdSrc, 4, false>(p, rows, s);
  if (N <= 8) return chunk::launch_chunk_bwd<CfBwdSrc, 8, false>(p, rows, s);
  if (N <= 16)
    return chunk::launch_chunk_bwd<CfBwdSrc, 16, false>(p, rows, s);
  return chunk::launch_chunk_bwd<CfBwdSrc, 16, true>(p, rows, s);
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
