// Fused SS2D epilogue kernels for Hopper (sm_90a), plain C interface for
// ctypes. Built by sigma_tpu_torch/ops/_build.py with nvcc.
//
// Replaces sigma_tpu/ops/pallas_merge_ln_gate.py:
//   K6 merge_ln_gate_fwd_kernel — _fwd_kernel (:54, pallas_call in _fwd :153)
//   K7 merge_ln_gate_bwd_kernel — _bwd_kernel (:66, pallas_call in
//                                 _vjp_bwd :183)
// Per row (b, h, w), over its C channels, all arithmetic fp32:
//     s     = y_hw[b,h,w,:] + y_wh[b,w,h,:]
//     xhat  = (s - mean(s)) * rsqrt(mean((s - mean(s))^2) + eps)
//     out   = (xhat * gamma + beta) * z * sigmoid(z)          (fp32 out)
// and, given dout:
//     dnorm = dout * z * sigmoid(z)
//     dz    = dout * norm * sigmoid(z) * (1 + z * (1 - sigmoid(z)))
//     dxhat = dnorm * gamma
//     ds    = rs * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
//     dy_hw[b,h,w,:] = dy_wh[b,w,h,:] = ds
//     dgamma = sum over rows of dnorm * xhat, dbeta = sum of dnorm
//
// Bound: device memory. K6 reads y_hw, y_wh and z and writes out (16 bytes
// per element at fp32) for ~14 flops; K7 reads four tensors and writes
// three (28 bytes) for ~32 flops. Design: one warp per row. A row is C
// contiguous values in every tensor, the transposed operand's row (b, w, h)
// as well, so every load is coalesced with no tile transpose (the TPU
// kernel's transposed BlockSpec, pallas_merge_ln_gate.py:147-150). A lane
// keeps its share of the row in registers (NV chunks of 4 values: one
// float4 / 8-byte bf16 access per chunk when C and every row stride are
// multiples of 4 and the pointers aligned, else 4 lane-strided scalar
// accesses), so the row is read from device memory once for the two-pass
// statistics; the row sums are warp shuffles. K7's dgamma/dbeta: each warp
// walks rows with a grid stride, adding into its own fp32 slice of shared
// memory; at the end each block sums its warps in a fixed order into one
// row of (n_blocks, C) partials that the wrapper sums with torch.sum. No
// atomics, so a rerun gives the same bits. Input rows may have any stride
// (z is a column slice of in_proj's output); outputs are contiguous.
//
// io fp32 or bf16 for y_hw, y_wh, z and the gradients written for them;
// out, dout, gamma, beta and the partials fp32. The kernels launch on the
// caller's stream, allocate nothing, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 8;  // rows in flight per block, one per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 4;  // values per lane per chunk
constexpr int kMaxChannels = 16 * 32 * kChunk;  // NV <= 16: C <= 2048

constexpr int kErrWidth = 10201;
constexpr int kErrArguments = 10202;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Channel of value k of a lane's chunk j. Vector layout: 4 neighbours per
// lane (one wide access). Scalar layout: lane-strided, so each of the 4
// accesses is coalesced across the warp.
template <bool VEC>
__device__ __forceinline__ int channel(int j, int k, int lane) {
  return VEC ? (j * 32 + lane) * kChunk + k : (j * kChunk + k) * 32 + lane;
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<const uint32_t*>(&a);
  q.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}

// chunk j of the row at p into v; zeros past C
template <bool VEC, typename T>
__device__ __forceinline__ void load_chunk(const T* p, int j, int lane, int C,
                                           float v[4]) {
  if (VEC) {
    const int c = channel<true>(j, 0, lane);
    if (c < C) {
      load4(p + c, v);
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int c = channel<false>(j, k, lane);
      v[k] = c < C ? to_f(p[c]) : 0.f;
    }
  }
}

template <bool VEC, typename T>
__device__ __forceinline__ void store_chunk(T* p, int j, int lane, int C,
                                            const float v[4]) {
  if (VEC) {
    const int c = channel<true>(j, 0, lane);
    if (c < C) store4(p + c, v);
  } else {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int c = channel<false>(j, k, lane);
      if (c < C) p[c] = from_f<T>(v[k]);
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

template <typename T>
struct Args {
  const T* yhw;  // (B, H, W, C) rows at stride ld_hw
  const T* ywh;  // (B, W, H, C) rows at stride ld_wh
  const T* z;    // (B, H, W, C) rows at stride ld_z
  const float* gamma;
  const float* beta;
  const float* dout;  // K7: (B, H, W, C) contiguous
  float* out;         // K6: (B, H, W, C) contiguous
  T* dyhw;            // K7: contiguous, like y_hw
  T* dywh;            // K7: contiguous, like y_wh
  T* dz;              // K7: contiguous, like z
  float* dgp;         // K7: (gridDim.x, C) partials of dgamma
  float* dbp;         // K7: (gridDim.x, C) partials of dbeta
  long long rows;     // B * H * W
  int H, W, C;
  long long ld_hw, ld_wh, ld_z;
  float eps;
};

// the row of y_wh, (b, w, h), that merges into row r = (b, h, w)
template <typename T>
__device__ __forceinline__ long long wh_row(const Args<T>& p, long long r) {
  const long long hw = static_cast<long long>(p.H) * p.W;
  const long long b = r / hw;
  const int rem = static_cast<int>(r - b * hw);
  const int h = rem / p.W;
  const int w = rem - h * p.W;
  return (b * p.W + w) * p.H + h;
}

// s <- xhat of row r (zeros past C); returns rsqrt(var + eps)
template <typename T, int NV, bool VEC>
__device__ __forceinline__ float normalize_row(const Args<T>& p, long long r,
                                               int lane, float (&s)[NV][4]) {
  const T* a = p.yhw + r * p.ld_hw;
  const T* b = p.ywh + wh_row(p, r) * p.ld_wh;
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float t[4];
    load_chunk<VEC>(a, j, lane, p.C, s[j]);
    load_chunk<VEC>(b, j, lane, p.C, t);
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      s[j][k] += t[k];
      sum += s[j][k];
    }
  }
  const float mu = warp_sum(sum) / p.C;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float x = channel<VEC>(j, k, lane) < p.C ? s[j][k] - mu : 0.f;
      s[j][k] = x;
      sq += x * x;
    }
  }
  const float rs = rsqrtf(warp_sum(sq) / p.C + p.eps);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) s[j][k] *= rs;
  }
  return rs;
}

template <typename T, int NV, bool VEC>
__global__ void __launch_bounds__(kThreads)
    merge_ln_gate_fwd_kernel(const Args<T> p) {
  const int lane = threadIdx.x & 31;
  const long long r =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= p.rows) return;
  float s[NV][4];
  normalize_row<T, NV, VEC>(p, r, lane, s);
  const T* zr = p.z + r * p.ld_z;
  float* o = p.out + r * p.C;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float z[4], g[4], b[4], y[4];
    load_chunk<VEC>(zr, j, lane, p.C, z);
    load_chunk<VEC>(p.gamma, j, lane, p.C, g);
    load_chunk<VEC>(p.beta, j, lane, p.C, b);
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      y[k] = (s[j][k] * g[k] + b[k]) * (z[k] * sigmoid(z[k]));
    store_chunk<VEC>(o, j, lane, p.C, y);
  }
}

template <typename T, int NV, bool VEC>
__global__ void __launch_bounds__(kThreads)
    merge_ln_gate_bwd_kernel(const Args<T> p) {
  // (kWarps, 2, C) fp32: each warp's running dgamma and dbeta sums
  extern __shared__ float4 acc4[];
  float* acc = reinterpret_cast<float*>(acc4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* dg = acc + static_cast<size_t>(warp) * 2 * p.C;
  float* db = dg + p.C;
  for (int c = lane; c < 2 * p.C; c += 32) dg[c] = 0.f;
  __syncwarp();

  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + warp;
       r < p.rows; r += static_cast<long long>(gridDim.x) * kWarps) {
    float s[NV][4], dx[NV][4];
    const float rs = normalize_row<T, NV, VEC>(p, r, lane, s);
    const T* zr = p.z + r * p.ld_z;
    const float* dr = p.dout + r * p.C;
    T* dzr = p.dz + r * p.C;
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float z[4], g[4], b[4], d[4], dzv[4], ag[4], ab[4];
      load_chunk<VEC>(zr, j, lane, p.C, z);
      load_chunk<VEC>(p.gamma, j, lane, p.C, g);
      load_chunk<VEC>(p.beta, j, lane, p.C, b);
      load_chunk<VEC>(dr, j, lane, p.C, d);
      load_chunk<VEC>(dg, j, lane, p.C, ag);
      load_chunk<VEC>(db, j, lane, p.C, ab);
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const float sig = sigmoid(z[k]);
        const float norm = s[j][k] * g[k] + b[k];
        const float dnorm = d[k] * (z[k] * sig);
        dzv[k] = (d[k] * norm) * (sig * (1.f + z[k] * (1.f - sig)));
        dx[j][k] = dnorm * g[k];
        m1 += dx[j][k];
        m2 += dx[j][k] * s[j][k];
        ag[k] += dnorm * s[j][k];
        ab[k] += dnorm;
      }
      store_chunk<VEC>(dzr, j, lane, p.C, dzv);
      store_chunk<VEC>(dg, j, lane, p.C, ag);
      store_chunk<VEC>(db, j, lane, p.C, ab);
    }
    m1 = warp_sum(m1) / p.C;
    m2 = warp_sum(m2) / p.C;
    T* ha = p.dyhw + r * p.C;
    T* wa = p.dywh + wh_row(p, r) * p.C;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float ds[4];
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        ds[k] = rs * (dx[j][k] - m1 - s[j][k] * m2);
      store_chunk<VEC>(ha, j, lane, p.C, ds);
      store_chunk<VEC>(wa, j, lane, p.C, ds);
    }
  }

  __syncthreads();
  for (int c = threadIdx.x; c < p.C; c += kThreads) {
    float g = 0.f, b = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      g += acc[static_cast<size_t>(w) * 2 * p.C + c];
      b += acc[static_cast<size_t>(w) * 2 * p.C + p.C + c];
    }
    p.dgp[static_cast<size_t>(blockIdx.x) * p.C + c] = g;
    p.dbp[static_cast<size_t>(blockIdx.x) * p.C + c] = b;
  }
}

template <typename T, int NV, bool VEC>
int launch(const Args<T>& p, bool backward, int n_blocks,
           cudaStream_t stream) {
  if (!backward) {  // K6: one warp per row
    const long long blocks = (p.rows + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL) return kErrArguments;
    merge_ln_gate_fwd_kernel<T, NV, VEC>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float) * 2 * kWarps * static_cast<size_t>(p.C);
  auto kernel = merge_ln_gate_bwd_kernel<T, NV, VEC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// NV, the chunks per lane, is the least instantiated value covering C
template <typename T, bool VEC>
int launch_nv(const Args<T>& p, bool backward, int n_blocks,
              cudaStream_t stream) {
  const int nv = (p.C + 32 * kChunk - 1) / (32 * kChunk);
#define SIGMA_MLG_NV(n) \
  if (nv <= n) return launch<T, n, VEC>(p, backward, n_blocks, stream)
  SIGMA_MLG_NV(1);
  SIGMA_MLG_NV(2);
  SIGMA_MLG_NV(3);
  SIGMA_MLG_NV(4);
  SIGMA_MLG_NV(6);
  SIGMA_MLG_NV(8);
  SIGMA_MLG_NV(12);
  SIGMA_MLG_NV(16);
#undef SIGMA_MLG_NV
  return kErrWidth;
}

bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// The vector layout needs whole 4-value chunks on aligned addresses in
// every tensor the kernel touches (null pointers, unused, pass).
template <typename T>
int dispatch(const Args<T>& p, bool backward, int n_blocks,
             cudaStream_t stream) {
  const size_t io = kChunk * sizeof(T), f32 = kChunk * sizeof(float);
  const bool vec = p.C % kChunk == 0 && p.ld_hw % kChunk == 0 &&
                   p.ld_wh % kChunk == 0 && p.ld_z % kChunk == 0 &&
                   aligned(p.yhw, io) && aligned(p.ywh, io) &&
                   aligned(p.z, io) && aligned(p.gamma, f32) &&
                   aligned(p.beta, f32) && aligned(p.out, f32) &&
                   aligned(p.dout, f32) && aligned(p.dyhw, io) &&
                   aligned(p.dywh, io) && aligned(p.dz, io);
  return vec ? launch_nv<T, true>(p, backward, n_blocks, stream)
             : launch_nv<T, false>(p, backward, n_blocks, stream);
}

template <typename T>
Args<T> make_args(const void* yhw, const void* ywh, const void* z,
                  const float* gamma, const float* beta, int B, int H, int W,
                  int C, int ld_hw, int ld_wh, int ld_z, float eps) {
  Args<T> p{};
  p.yhw = static_cast<const T*>(yhw);
  p.ywh = static_cast<const T*>(ywh);
  p.z = static_cast<const T*>(z);
  p.gamma = gamma;
  p.beta = beta;
  p.rows = static_cast<long long>(B) * H * W;
  p.H = H;
  p.W = W;
  p.C = C;
  p.ld_hw = ld_hw;
  p.ld_wh = ld_wh;
  p.ld_z = ld_z;
  p.eps = eps;
  return p;
}

template <typename T>
int run_fwd(const void* yhw, const void* ywh, const void* z,
            const float* gamma, const float* beta, float* out, int B, int H,
            int W, int C, int ld_hw, int ld_wh, int ld_z, float eps,
            cudaStream_t stream) {
  Args<T> p = make_args<T>(yhw, ywh, z, gamma, beta, B, H, W, C, ld_hw,
                           ld_wh, ld_z, eps);
  p.out = out;
  return dispatch(p, false, 0, stream);
}

template <typename T>
int run_bwd(const void* yhw, const void* ywh, const void* z,
            const float* gamma, const float* beta, const float* dout,
            void* dyhw, void* dywh, void* dz, float* dgp, float* dbp, int B,
            int H, int W, int C, int ld_hw, int ld_wh, int ld_z, int n_blocks,
            float eps, cudaStream_t stream) {
  Args<T> p = make_args<T>(yhw, ywh, z, gamma, beta, B, H, W, C, ld_hw,
                           ld_wh, ld_z, eps);
  p.dout = dout;
  p.dyhw = static_cast<T*>(dyhw);
  p.dywh = static_cast<T*>(dywh);
  p.dz = static_cast<T*>(dz);
  p.dgp = dgp;
  p.dbp = dbp;
  return dispatch(p, true, n_blocks, stream);
}

bool bad_shape(int B, int H, int W, int C, int ld_hw, int ld_wh, int ld_z) {
  return B <= 0 || H <= 0 || W <= 0 || C <= 0 || ld_hw < C || ld_wh < C ||
         ld_z < C;
}

}  // namespace

extern "C" {

// K6. y_hw, z: (B, H, W, C), y_wh: (B, W, H, C), each as rows of C values
// at the given row stride (elements), in the io type (bf16 != 0: bf16,
// else fp32); gamma, beta: (C,) fp32; out: (B, H, W, C) fp32 contiguous.
int sigma_mlg_fwd(const void* yhw, const void* ywh, const void* z,
                  const float* gamma, const float* beta, float* out, int B,
                  int H, int W, int C, int ld_hw, int ld_wh, int ld_z,
                  int bf16, float eps, void* stream) {
  if (bad_shape(B, H, W, C, ld_hw, ld_wh, ld_z)) return kErrArguments;
  if (C > kMaxChannels) return kErrWidth;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? run_fwd<__nv_bfloat16>(yhw, ywh, z, gamma, beta, out, B, H,
                                       W, C, ld_hw, ld_wh, ld_z, eps, s)
              : run_fwd<float>(yhw, ywh, z, gamma, beta, out, B, H, W, C,
                               ld_hw, ld_wh, ld_z, eps, s);
}

// K7. Inputs as for sigma_mlg_fwd, plus dout (B, H, W, C) fp32 contiguous.
// Writes dyhw (B, H, W, C), dywh (B, W, H, C) and dz (B, H, W, C),
// contiguous, in the io type, and the (n_blocks, C) fp32 partials dgp and
// dbp of dgamma and dbeta (n_blocks >= 1 blocks walk the rows).
int sigma_mlg_bwd(const void* yhw, const void* ywh, const void* z,
                  const float* gamma, const float* beta, const float* dout,
                  void* dyhw, void* dywh, void* dz, float* dgp, float* dbp,
                  int B, int H, int W, int C, int ld_hw, int ld_wh, int ld_z,
                  int n_blocks, int bf16, float eps, void* stream) {
  if (bad_shape(B, H, W, C, ld_hw, ld_wh, ld_z) || n_blocks <= 0)
    return kErrArguments;
  if (C > kMaxChannels) return kErrWidth;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? run_bwd<__nv_bfloat16>(yhw, ywh, z, gamma, beta, dout, dyhw,
                                       dywh, dz, dgp, dbp, B, H, W, C, ld_hw,
                                       ld_wh, ld_z, n_blocks, eps, s)
              : run_bwd<float>(yhw, ywh, z, gamma, beta, dout, dyhw, dywh,
                               dz, dgp, dbp, B, H, W, C, ld_hw, ld_wh, ld_z,
                               n_blocks, eps, s);
}

const char* sigma_mlg_error_string(int code) {
  switch (code) {
    case kErrWidth:
      return "the epilogue kernels take at most 2048 channels";
    case kErrArguments:
      return "invalid merge_ln_gate arguments";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
