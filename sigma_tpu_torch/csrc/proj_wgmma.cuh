// The fused scans' projection on Hopper's warpgroup MMAs, shared by K2
// (csrc/scan_g_fwd.cu) and K4 (csrc/scan_g_bwd.cu): per chain (b, g)
//     P[b, g, t] = u[b, g, t] [W_dt | W_B | W_C][g]      (dg + 2N columns)
// into an fp32 stream P (batch, G, L, dg + 2N) that the scan reads once.
// K4 launches the same code on the same operands, so the streams it scans
// back are the bits K2 scanned and checkpointed.
//
// Replaces the projection dots of sigma_tpu/ops/pallas_scan_g.py::
// _fwd_kernel (:149) and _bwd_kernel (:305), which the TPU ran inside the
// scan's grid step.
//
// A block of kThreads = 288 threads computes a 128 x 64 tile of (tokens,
// columns): two consumer warpgroups, 64 tokens each, run wgmma.mma_async
// (m64n64) on operands that one producer warp brings into shared memory
// with TMA (cp.async.bulk.tensor, 128-byte swizzle), through a ring of
// kStages k-tiles, each with a "full" mbarrier (the copy's bytes landed)
// and an "empty" one (both warpgroups are done with it). A k-tile is one
// 128-byte swizzle row of the operands' contiguous axis, the channels of
// u: 32 fp32 or 64 bf16 values. Both operands are read K-major: u as it
// lies (token rows, channels contiguous), the weights as weight_prep_kernel
// lays them out, (G, dg + 2N, dgk). TMA fills rows past L, columns past
// dg + 2N and channels past dg with zeros, so ragged edges need no masks
// until the stores. dgk is the row length in memory, dg rounded up so
// that a row is a multiple of 16 bytes (TMA's stride rule); the wrapper
// pads u with zero channels when dg is not, weight_prep_kernel the
// weights.
//
// Number formats: at bf16 io, m64n64k16 bf16 products from shared memory
// (exact products, fp32 sums). At fp32 io, 3xTF32 (fp32's accuracy, as
// the mma.sync tiles before this had it): weight_prep_kernel splits the
// weights into TF32 heads and the TF32 rounding of their remainders (two
// weight tiles a stage), u is split the same way in registers
// (cvt.rna.tf32), and each k8 step runs three m64n64k8 TF32 products with
// A from registers: a_lo w_hi, a_hi w_lo, a_hi w_hi (a_lo w_lo, below
// fp32's last bit, dropped). tests/test_torch_port_chunk_scan.py emulates
// the split on the CPU.
//
// Bound: at the main path's shapes the bytes (u read, P written: 4 (dg +
// 2N) bytes a token and chain against 2 dg (dg + 2N) flops, at 3xTF32
// three times that on the tensor cores).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace wg {

constexpr int kBM = 128;        // tokens per block: two m64 warpgroups
constexpr int kBN = 64;         // columns per block
constexpr int kRowBytes = 128;  // a k-tile: one 128-byte swizzle row
constexpr int kStages = 3;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kErrTensorMap = 10004;

template <typename T>
struct Tiles {
  static constexpr bool kSplit = std::is_same<T, float>::value;  // 3xTF32
  static constexpr int kBK = kRowBytes / sizeof(T);  // k per k-tile
  static constexpr int kU = kBM * kRowBytes;          // 16 KB of u
  static constexpr int kW = kBN * kRowBytes;          // 8 KB a weight tile
  static constexpr int kStage = kU + (kSplit ? 2 : 1) * kW;
  static constexpr size_t kSmem = (size_t)kStages * kStage + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// (a copy that never lands is a fault: trap rather than hold the card)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (long long spin = 0; !done; ++spin) {
    if (spin > (1ll << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// a box of the 3-d tensor map at (c0, c1, c2) into shared memory, its bytes
// counted on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// the wgmma descriptor of a K-major tile of 128-byte rows, 128-byte
// swizzle, 1024-byte aligned: leading offset 16 bytes (unused), stride
// between 8-row groups 1024 bytes. Advancing k by 32 bytes adds 2.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint64_t a = smem_u32(tile);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving the accumulators across the async MMAs
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a b: a 64 x 8 TF32 fragment in registers, b 8 x 64 from shared
// memory (K-major), fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a b: a 64 x 16 and b 16 x 64 bf16, both from shared memory
// (K-major), fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// element (row, k) of a 128-byte-swizzled fp32 tile (rows of 32 values)
__device__ __forceinline__ float swz_at(const uint8_t* tile, int row, int k) {
  const int chunk = (k >> 2) ^ (row & 7);
  return *reinterpret_cast<const float*>(tile + row * kRowBytes +
                                         chunk * 16 + (k & 3) * 4);
}

struct ProjArgs {
  float* P;  // (batch * G, L, ncol) fp32
  int G, L, dgk, ncol, n_u;
};

// Block (token tile x, column tile y, chain z = b G + g). Tag names the
// caller (an empty type of its own), so that a trace tells K2's launches
// from K4's; the code is the same. Map mu0 / mu1:
// u of layout 0 / 1 (n_u 2: (dgk, L, batch), chain g on layout g; n_u 1:
// mu0 is (dgk, L, batch G)); mwh / mwl: the transposed weights' heads and,
// 3xTF32, remainders, (dgk, ncol, G).
template <typename T, class Tag>
__global__ void __launch_bounds__(kThreads, 2)
proj_kernel(const __grid_constant__ CUtensorMap mu0,
            const __grid_constant__ CUtensorMap mu1,
            const __grid_constant__ CUtensorMap mwh,
            const __grid_constant__ CUtensorMap mwl, const ProjArgs a) {
  using Tl = Tiles<T>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int z = blockIdx.z, g = z % a.G, b = z / a.G;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int nk = (a.dgk + Tl::kBK - 1) / Tl::kBK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: one thread starts the copies
    if (tid == kConsumers) {
      const CUtensorMap* mu = a.n_u == 2 && g == 1 ? &mu1 : &mu0;
      const int zu = a.n_u == 2 ? b : z;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], (kt / kStages - 1) & 1);
        uint8_t* st = smem + s * Tl::kStage;
        mbar_expect_tx(&full[s], Tl::kStage);
        tma_load(st, mu, &full[s], kt * Tl::kBK, m0, zu);
        tma_load(st + Tl::kU, &mwh, &full[s], kt * Tl::kBK, n0, g);
        if (Tl::kSplit)
          tma_load(st + Tl::kU + Tl::kW, &mwl, &full[s], kt * Tl::kBK, n0,
                   g);
      }
    }
    return;
  }

  // the consumers: warpgroup wq takes tokens [64 wq, 64 wq + 64)
  const int wq = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int grp = lane / 4, tig = lane % 4;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint8_t* st = smem + s * Tl::kStage;
    const uint8_t* ua = st + wq * 64 * kRowBytes;
    const uint64_t wh = desc_sw128(st + Tl::kU);
    if constexpr (Tl::kSplit) {
      const uint64_t wl = desc_sw128(st + Tl::kU + Tl::kW);
      // the warp's 16 rows of each k8 step: (grp, tig), (grp + 8, tig),
      // (grp, tig + 4), (grp + 8, tig + 4), heads and remainders
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float v = swz_at(ua, warp * 16 + grp + (q & 1) * 8,
                                 kk * 8 + tig + (q >> 1) * 4);
          ah[kk][q] = to_tf32(v);
          al[kk][q] = to_tf32(v - __uint_as_float(ah[kk][q]));
        }
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma_tf32(acc, al[kk], wh + 2 * kk);
        mma_tf32(acc, ah[kk], wl + 2 * kk);
        mma_tf32(acc, ah[kk], wh + 2 * kk);
      }
    } else {
      const uint64_t ud = desc_sw128(ua);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma_bf16(acc, ud + 2 * kk, wh + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
    mbar_arrive(&empty[s]);
  }

  // the tile into P: thread (grp, tig) of warp w holds rows 16 w + grp (+ 8)
  // of its warpgroup's 64, columns 8 i + 2 tig (+ 1)
  float* out = a.P + (size_t)z * a.L * a.ncol;
  const bool pair = a.ncol % 2 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = n0 + 8 * i + 2 * tig;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wq * 64 + warp * 16 + grp + 8 * h;
      if (row >= a.L || col >= a.ncol) continue;
      float* o = out + (size_t)row * a.ncol + col;
      const float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
      if (pair && col + 1 < a.ncol) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        o[0] = v0;
        if (col + 1 < a.ncol) o[1] = v1;
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder (the CUDA runtime has loaded libcuda)
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a 3-d map of rows of `d0` elements (d0 * sizeof(T) bytes apart), d1 rows a
// slab, d2 slabs; boxes of (kBK, box1, 1), 128-byte swizzle, zeros outside
template <typename T>
bool make_map(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1,
              uint64_t d2, uint32_t box1) {
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * sizeof(T), d0 * d1 * sizeof(T)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(Tiles<T>::kBK), box1, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  return enc(map,
             std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             3, const_cast<void*>(base), dims, strides, box, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The weights as the projection reads them: [W_dt | W_B | W_C] (G, dg,
// dg + 2N, from three (G, dg, *) tensors) transposed to (G, dg + 2N, dgk),
// zeros past dg; at fp32 io split into TF32 heads (cvt.rna) and the TF32
// rounding of their remainders (lo), at bf16 io copied (lo unused).
template <typename T>
__global__ void weight_prep_kernel(const T* wdt, const T* wb, const T* wc,
                                   T* hi, T* lo, int G, int dg, int dgk,
                                   int N) {
  const int ncol = dg + 2 * N;
  const size_t total = (size_t)G * ncol * dgk;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int k = i % dgk;
    const size_t r = i / dgk;
    const int c = r % ncol;
    const size_t row = (r / ncol) * dg + k;  // (g, k) of the sources
    float v = 0.f;
    if (k < dg)
      v = c < dg       ? to_float(wdt[row * dg + c])
          : c < dg + N ? to_float(wb[row * N + c - dg])
                       : to_float(wc[row * N + c - dg - N]);
    if constexpr (Tiles<T>::kSplit) {
      const float h = __uint_as_float(to_tf32(v));
      hi[i] = h;
      lo[i] = __uint_as_float(to_tf32(v - h));
    } else {
      hi[i] = __float2bfloat16(v);
    }
  }
}

// P = u [W_dt | W_B | W_C] for batch * G chains. uk0 / uk1: u with rows of
// dgk elements (n_u 2: two (batch, L, dgk) layouts; n_u 1: uk0 (batch, G,
// L, dgk)), rows 16-byte aligned; wdt (G, dg, dg), wb / wc (G, dg, N) in
// the io type; wt: scratch for the prepared weights, (2 at fp32, 1 at
// bf16) x G x (dg + 2N) x dgk elements of the io type. Returns 0 or an
// error code.
template <typename T, class Tag>
int launch_proj(const void* uk0, const void* uk1, const void* wdt,
                const void* wb, const void* wc, void* wt, float* P,
                int batch, int G, int L, int dg, int dgk, int N, int n_u,
                cudaStream_t stream) {
  using Tl = Tiles<T>;
  const int ncol = dg + 2 * N;
  if ((dgk * sizeof(T)) % 16 || dgk < dg) return kErrTensorMap;
  T* whi = static_cast<T*>(wt);
  T* wlo = whi + (size_t)G * ncol * dgk;
  weight_prep_kernel<T><<<(G * ncol * dgk + 255) / 256 < 1024
                              ? (G * ncol * dgk + 255) / 256
                              : 1024,
                          256, 0, stream>>>(
      static_cast<const T*>(wdt), static_cast<const T*>(wb),
      static_cast<const T*>(wc), whi, wlo, G, dg, dgk, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mu0, mu1, mwh, mwl;
  const uint64_t slabs = n_u == 2 ? batch : (uint64_t)batch * G;
  if (!make_map<T>(&mu0, uk0, dgk, L, slabs, kBM) ||
      !make_map<T>(&mu1, n_u == 2 ? uk1 : uk0, dgk, L, slabs, kBM) ||
      !make_map<T>(&mwh, whi, dgk, ncol, G, kBN) ||
      !make_map<T>(&mwl, Tl::kSplit ? wlo : whi, dgk, ncol, G, kBN))
    return kErrTensorMap;
  auto kernel = proj_kernel<T, Tag>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Tl::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const ProjArgs args{P, G, L, dgk, ncol, n_u};
  const dim3 grid((L + kBM - 1) / kBM, (ncol + kBN - 1) / kBN, batch * G);
  kernel<<<grid, kThreads, Tl::kSmem, stream>>>(mu0, mu1, mwh, mwl, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg
