// Backward selective-scan kernels for Hopper (sm_90a), fp32 or bf16 io,
// plain C interface for ctypes. Built by sigma_tpu_torch/ops/_build.py
// with nvcc.
//
// Replace sigma_tpu/ops/pallas_scan_g.py::_bwd_kernel (:305), reached
// through _bwd_call (:989: the streamed pallas_call :1111 and the
// fused-projection one :1060) and _bwd_call_ml (:1140, pallas_call :1225).
// The forward is csrc/scan_g_fwd.cu's; the gradients are those written
// out in csrc/chunk_bwd.cuh. A is the true A (the TPU kernel's A*log2e and
// ln2 factors are not carried over).
//
// K3 (streamed: dt, B, C read from device memory) and K4 (fused
// projection) are two operand sources (StreamBwdSrc, ProjBwdSrc: one type
// each, so that a trace tells their launches apart) of the chunk-parallel
// backward of csrc/chunk_bwd.cuh, which K11 (csrc/scan_img.cu) shares:
// each chunk's adjoint from a zero exit adjoint, a fixed-order carry pass,
// then the emission of every output from the true exit adjoints and the
// forward's 32-token checkpoints. Three launches (K4: four), counted as one
// call by the wrappers:
//   K4a bwd_proj_kernel — K4 only: [dt | B | C] = u [W_dt | W_B | W_C]
//     once per chain on the tensor cores into an fp32 scratch stream P
//     (batch, G, L, dg + 2N), with K2a's tiles (tc::proj_tile: 3xTF32), so
//     the streams K4 scans back are the bits K2 scanned and checkpointed.
//     From here on K4 is K3 reading dt / B / C out of P (under swap_c,
//     C from the partner chain's P).
//   then adjoint_local_kernel, adjoint_carry_kernel, adjoint_emit_kernel
//     (chunk_bwd.cuh): du (the direct term; K5 adds the chain term), dd;
//     dA, dbias, dD as per-chunk partials; dB, dC as per-block partials
//     (batch, nblk, G, L, N), dC routed to the chain whose projection made
//     the C. The wrapper sums the partials over chunks, channel blocks and
//     batch in a fixed order, so a rerun gives the same bits for all seven
//     gradients.
//   Bound: device memory and the fp32 cores about evenly. Per token and
//   channel ~40 bytes of device traffic (u, dt, dy read, du, dd written,
//   the checkpoints), against ~22 flops and two exps per token, channel
//   and state (the local pass and the re-sweep); at d_state 16 the two
//   bounds lie within 10% of each other. K4 adds its projections,
//   2 dg (dg + 2N) flops per token and chain on the TF32 tensor cores.
//   Design: work spreads over (chunk, channel tile, chain, batch): 3,600
//   blocks at the train step's ConMB stage 0 (L 38,400, dg 192).
//   bf16 io (as the TPU kernel's, :977-1000): the operand sources are
//   templates over the io type. u and dy (K3: dt, B, C too) are read as
//   bf16 and converted to fp32 in registers; the adjoints, the carries,
//   hck and every sum stay fp32. A value is stored in bf16 only where it
//   is final: K3's du and dd. K4's du (K5 adds the chain term into it) and
//   dd (K5's operand) stay fp32, and so do the per-chunk and per-block
//   partials; the wrapper rounds each once, after its last sum. At fp32
//   io the conversions are the identity: the same code, the same bits.
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
//   the MMAs, 16-byte copies along each operand's contiguous axis (a
//   bf16 u, the weight gradient's A operand, is converted to fp32 through
//   registers on its way into shared memory: exact in TF32). [dB | dC] and [W_B | W_C]
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "chunk_bwd.cuh"
#include "tc_gemm.cuh"

namespace {

using namespace chunk;  // BwdArgs, launch_chunk_bwd, kSeg, kChunk

constexpr int kErrStateWidth = 10001;
constexpr int kErrArguments = 10003;

// K3's and K4's operands for the chunk backward (csrc/chunk_bwd.cuh).
// u / dy / du: n_u == 2: two layouts (batch, L, dg), chain g on layout g;
// n_u == 1: (batch, G, L, dg) in slot 0. The dt / B / C streams: chain (b,
// g)'s token t at dt[(b G + g) sdt + t ldt], B / C[(b G + g) sbc + t ldbc]
// (C of the chain whose projection made it); K3: (batch, G, L, dg) and
// (batch, G, L, N); K4: columns 0, dg and dg + N of P. dd (batch, G, L,
// dg); dBp / dCp (batch, nblk, G, L, N) per-channel-block partials, dC
// routed to the chain whose projection made the C under swap_c; hck
// (batch, G, n_ck, N, dg). Types: T of u / dy, TS of the dt / B / C
// streams, TO of du / dd; the rest fp32.
template <typename T, typename TS, typename TO>
struct GroupBwdSrc : BwdArgs {
  const T* u[2];
  const T* dy[2];
  TO* du[2];
  const TS* dt;
  const TS* Bm;
  const TS* Cm;
  const float* hck;
  TO* dd;
  float* dBp;
  float* dCp;
  size_t sdt, sbc;
  int ldt, ldbc, n_u, reverse, swap_c, nblk;

  struct View {
    const T *u, *dy;
    const TS *dt, *Bm, *Cm;
    const float* hck;
    TO *du, *dd;
    float *dB, *dC;
    size_t blk_step;  // between two channel blocks' partials
    int ldt, ldbc, dg, N;
    __device__ float u_at(int t, int e) const {
      return to_f(u[(size_t)t * dg + e]);
    }
    __device__ float dy_at(int t, int e) const {
      return to_f(dy[(size_t)t * dg + e]);
    }
    __device__ float dt_at(int t, int e) const {
      return to_f(dt[(size_t)t * ldt + e]);
    }
    __device__ float b_at(int t, int n) const {
      return to_f(Bm[(size_t)t * ldbc + n]);
    }
    __device__ float c_at(int t, int n) const {
      return to_f(Cm[(size_t)t * ldbc + n]);
    }
    __device__ void put_du(int t, int e, float v) const {
      du[(size_t)t * dg + e] = from_f<TO>(v);
    }
    __device__ void put_dd(int t, int e, float v) const {
      dd[(size_t)t * dg + e] = from_f<TO>(v);
    }
    __device__ void put_dbc(int blk, int t, int n, float vb, float vc) const {
      const size_t o = blk * blk_step + (size_t)t * N + n;
      dB[o] = vb;
      dC[o] = vc;
    }
  };
  __device__ __host__ size_t chain_offset(int b, int g) const {
    return n_u == 2 ? (size_t)b * L * dg : ((size_t)b * G + g) * L * dg;
  }
  __device__ bool rev(int) const { return reverse; }
  __device__ View view(int b, int g) const {
    const size_t bg = (size_t)b * G + g, off = chain_offset(b, g);
    const int j = n_u == 2 ? g : 0;
    const int gp = swap_c ? (g ^ 1) : g;
    const size_t part = (size_t)b * nblk * G;
    return View{u[j] + off,
                dy[j] + off,
                dt + bg * sdt,
                Bm + bg * sbc,
                Cm + ((size_t)b * G + gp) * sbc,
                hck + bg * n_ck_of(L) * N * dg,
                du[j] + off,
                dd + bg * L * dg,
                dBp + (part + g) * L * N,
                dCp + (part + gp) * L * N,
                (size_t)G * L * N,
                ldt,
                ldbc,
                dg,
                N};
  }
};

// K3 and K4 as two types, so that a trace tells their launches apart. K3
// reads its streams in the io type T and stores its final du and dd in
// it; K4 reads dt / B / C from its fp32 projection stream and stores du
// and dd in fp32 for K5.
template <typename T>
struct StreamBwdSrc : GroupBwdSrc<T, T, T> {};
template <typename T>
struct ProjBwdSrc : GroupBwdSrc<T, float, float> {};

// K4a: P[b, g] = u[b, g] [W_dt | W_B | W_C][g], as K2a (the weights in the
// io type, as K2 takes them, so that P has K2's bits)
template <typename T>
__global__ void __launch_bounds__(tc::kGemmThreads)
bwd_proj_kernel(const ProjBwdSrc<T> p, const T* wdt, const T* wbc,
                float* P) {
  const int g = blockIdx.z % p.G, b = blockIdx.z / p.G;
  const int dg = p.dg, N = p.N;
  tc::proj_tile<T>(p.u[p.n_u == 2 ? g : 0] + p.chain_offset(b, g),
                   wdt + (size_t)g * dg * dg, wbc + (size_t)g * dg * 2 * N,
                   P + ((size_t)b * p.G + g) * p.L * (dg + 2 * N), p.L, dg,
                   N, blockIdx.x * tc::kBM, blockIdx.y);
}

template <class S>
int dispatch_bwd(const S& p, int batch, cudaStream_t s) {
  const int chains = batch * p.G;
  if (p.N <= 4) return launch_chunk_bwd<S, 4, false>(p, chains, s);
  if (p.N <= 8) return launch_chunk_bwd<S, 8, false>(p, chains, s);
  if (p.N <= 16) return launch_chunk_bwd<S, 16, false>(p, chains, s);
  return kErrStateWidth;
}

// ---------------------------------------------------------------- K5
// 1xTF32 (csrc/tc_gemm.cuh): admitted by tests/test_torch_port_tf32.py,
// inside the fp32 gradient tier at the longest contraction
constexpr bool kSplitK5 = false;

struct GradArgs {
  const void* u[2];   // as BwdArgs, fp32 or bf16 (weight_grad_kernel's T)
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
// u of type T: fp32 copied by cp.async, bf16 through registers.
template <typename T>
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
  const T* ub = static_cast<const T*>(p.u[p.n_u == 2 ? g : 0]) +
                u_base(p.n_u, p.G, p.L, dg, b, g);
  const float* zb = in_dd ? p.dd + tok * dg : p.dbc + tok * 2 * p.N;
  const bool vu = vec_ok(ub, dg), vz = vec_ok(zb, nz);
  const int ntiles = (t1 - t0 + kBK - 1) / kBK;
  float acc[2][4][4];
  if constexpr (std::is_same<T, float>::value) {
    gemm_loop_async<true, true, kSplitK5>(
        ntiles, dg - m0, nz - n0,
        [=](int kt, float* sa, float* sb) {
          k_tile_async(sa, ub, dg, t0 + kt * kBK, t1, m0, dg, vu);
          k_tile_async(sb, zb, nz, t0 + kt * kBK, t1, n0, nz, vz);
        },
        [=](int kt) { return t1 - t0 - kt * kBK; }, acc);
  } else {
    gemm_loop<true, true, kSplitK5, KTile<T>, KTile<float>>(
        ntiles, dg - m0, nz - n0,
        [=](int kt, KTile<T>& ta, KTile<float>& tb) {
          ta.load(ub, dg, t0 + kt * kBK, t1, m0, dg, vu);
          tb.load(zb, nz, t0 + kt * kBK, t1, n0, nz, vz);
          return t1 - t0 - kt * kBK;
        },
        acc);
  }
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

// K3. u, dt, dy, du, dd: (batch, G, L, dg); Bm, Cm: (batch, G, L, N), all
// in the io type (bf16 when bf16, else fp32); A: (G, N, dg); bias, Dk:
// (G, dg); hck: (batch, G, nck, N, dg) from K1; dA: (batch, G, n_chunk, N,
// dg); dbias, dD: (batch, G, n_chunk, dg); dBp, dCp: (batch, ceil(dg /
// 32), G, L, N); scratch lam (batch, G, n_chunk, N, dg), sd (batch, G,
// n_chunk, dg), n_chunk = ceil(L / 128). Those fp32.
int sigma_scan_bwd(const void* u, const void* dt, const float* A,
                   const void* Bm, const void* Cm, const float* bias,
                   const float* Dk, const float* hck, const void* dy,
                   void* du, void* dd, float* dA, float* dbias, float* dD,
                   float* dBp, float* dCp, float* lam, float* sd,
                   int n_chunk, int batch, int G, int L, int dg, int N,
                   int nck, int softplus, int reverse, int bf16,
                   void* stream) {
  if (bad_shape(batch, G, L, dg, N, 1) ||
      bad_chunks(batch, G, L, nck, n_chunk))
    return kErrArguments;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SIGMA_SCAN_BWD(T)                                                  \
  {                                                                        \
    StreamBwdSrc<T> p{};                                                   \
    set_bwd_args(p, A, bias, Dk, lam, sd, dA, dbias, dD, G, L, dg, N,      \
                 softplus, n_chunk);                                       \
    p.u[0] = static_cast<const T*>(u);                                     \
    p.dy[0] = static_cast<const T*>(dy);                                   \
    p.du[0] = static_cast<T*>(du);                                         \
    p.dt = static_cast<const T*>(dt);                                      \
    p.Bm = static_cast<const T*>(Bm);                                      \
    p.Cm = static_cast<const T*>(Cm);                                      \
    p.sdt = (size_t)L * dg;                                                \
    p.sbc = (size_t)L * N;                                                 \
    p.ldt = dg;                                                            \
    p.ldbc = N;                                                            \
    p.hck = hck;                                                           \
    p.dd = static_cast<T*>(dd);                                            \
    p.dBp = dBp;                                                           \
    p.dCp = dCp;                                                           \
    p.n_u = 1;                                                             \
    p.reverse = reverse;                                                   \
    p.nblk = (dg + kBwdChan - 1) / kBwdChan;                               \
    return dispatch_bwd(p, batch, s);                                      \
  }
  if (bf16) SIGMA_SCAN_BWD(__nv_bfloat16)
  SIGMA_SCAN_BWD(float)
#undef SIGMA_SCAN_BWD
}

// K4. n_u == 2: u0/u1, dy0/dy1, du0/du1 are the two layouts (batch, L, dg)
// and G == 2; n_u == 1: slot 0 is (batch, G, L, dg). u, dy, wdt: (G, dg,
// dg) and wbc: (G, dg, 2N), [W_B | W_C], in the io type; du, dd and the
// scratch P: (batch, G, L, dg + 2N) fp32; the rest as for sigma_scan_bwd,
// with dCp routed to the partner chain under swap_c (G even).
int sigma_scan_proj_bwd(const void* u0, const void* u1, const void* wdt,
                        const void* wbc, const float* A, const float* bias,
                        const float* Dk, const float* hck, const void* dy0,
                        const void* dy1, float* du0, float* du1, float* P,
                        float* dd, float* dA, float* dbias, float* dD,
                        float* dBp, float* dCp, float* lam, float* sd,
                        int n_chunk, int batch, int G, int L, int dg, int N,
                        int nck, int n_u, int softplus, int reverse,
                        int swap_c, int bf16, void* stream) {
  if (bad_shape(batch, G, L, dg, N, n_u) || (swap_c && G % 2) ||
      bad_chunks(batch, G, L, nck, n_chunk))
    return kErrArguments;
  if (N > 16) return kErrStateWidth;
  const size_t kz = (size_t)dg + 2 * N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SIGMA_PROJ_BWD(T)                                                  \
  {                                                                        \
    ProjBwdSrc<T> p{};                                                     \
    set_bwd_args(p, A, bias, Dk, lam, sd, dA, dbias, dD, G, L, dg, N,      \
                 softplus, n_chunk);                                       \
    p.u[0] = static_cast<const T*>(u0);                                    \
    p.u[1] = static_cast<const T*>(u1);                                    \
    p.dy[0] = static_cast<const T*>(dy0);                                  \
    p.dy[1] = static_cast<const T*>(dy1);                                  \
    p.du[0] = du0;                                                         \
    p.du[1] = du1;                                                         \
    p.dt = P;                                                              \
    p.Bm = P + dg;                                                         \
    p.Cm = P + dg + N;                                                     \
    p.sdt = p.sbc = (size_t)L * kz;                                        \
    p.ldt = p.ldbc = static_cast<int>(kz);                                 \
    p.hck = hck;                                                           \
    p.dd = dd;                                                             \
    p.dBp = dBp;                                                           \
    p.dCp = dCp;                                                           \
    p.n_u = n_u;                                                           \
    p.reverse = reverse;                                                   \
    p.swap_c = swap_c;                                                     \
    p.nblk = (dg + kBwdChan - 1) / kBwdChan;                               \
    bwd_proj_kernel<T><<<tc::proj_grid(L, dg, N, batch * G),               \
                         tc::kGemmThreads, tc::proj_smem<T>(), s>>>(       \
        p, static_cast<const T*>(wdt), static_cast<const T*>(wbc), P);     \
    const cudaError_t err = cudaGetLastError();                            \
    if (err != cudaSuccess) return static_cast<int>(err);                  \
    return dispatch_bwd(p, batch, s);                                      \
  }
  if (bf16) SIGMA_PROJ_BWD(__nv_bfloat16)
  SIGMA_PROJ_BWD(float)
#undef SIGMA_PROJ_BWD
}

// K5. u as for sigma_scan_proj_bwd, in the io type (bf16 when bf16, else
// fp32); du fp32, added to; dd: (batch, G, L, dg); dbc: (batch, G, L,
// 2N), [dB | dC] summed over channel blocks, dC routed; wdt: (G, dg, dg);
// wbc: (G, dg, 2N), [W_B | W_C]; dW: (n_l * batch, G, dg, dg + 2N)
// partials, n_l token splits per batch element. Those fp32.
int sigma_proj_grad(const void* u0, const void* u1, float* du0, float* du1,
                    const float* dd, const float* dbc, const float* wdt,
                    const float* wbc, float* dW, int batch, int G, int L,
                    int dg, int N, int n_u, int n_l, int bf16,
                    void* stream) {
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
  // bf16 u: the register path's static shared memory, no dynamic
  if (bf16)
    weight_grad_kernel<__nv_bfloat16><<<gw, tc::kGemmThreads, 0, s>>>(p);
  else
    weight_grad_kernel<float><<<gw, tc::kGemmThreads, tc::kAsyncSmem, s>>>(p);
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
