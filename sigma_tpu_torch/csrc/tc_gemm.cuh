// Tensor-core tile products for the scan kernels (sm_90a), shared by
// csrc/scan_g_bwd.cu (K5) and csrc/scan_img.cu (K10's and K11's
// projections, the same tiles with a row map). K2's and K4's projection
// runs on the warpgroup MMAs of csrc/proj_wgmma.cuh.
//
// A block of kGemmThreads = 128 threads (four warps, 2 x 2) computes one
// kBM x kBN = 64 x 64 fp32 tile of a product C = A B over k-tiles of
// kBK = 32: A is kBM x K, B is K x kBN. Each warp owns 32 x 32 outputs and
// runs mma.sync.m16n8k8 on TF32 operands with fp32 accumulation, in one of
// two number formats (SPLIT): 1xTF32, one MMA per product on operands
// rounded to TF32 (10 mantissa bits), or 3xTF32, each operand split into a
// TF32 head and the TF32 rounding of its remainder, acc += a_lo b_hi +
// a_hi b_lo + a_hi b_hi (a_lo b_lo, below fp32's last bit, dropped), fp32
// accuracy at a third of the rate. tests/test_torch_port_tf32.py emulates
// both against fp64 at the train step's longest contraction: 3xTF32 is
// fp32's error, 1xTF32 about 3e-4 of max(|ref|, 1), inside the fp32
// gradient tier. A bf16 value is exact in TF32, so at bf16 io 1xTF32 is
// exact.
//
// fp32 operands reach shared memory by cp.async, bf16 ones through
// registers (converted on the way); either way the next k-tile is copied
// into the other of two buffers while the current one is multiplied, one
// barrier per k-tile. Every operand is read along its contiguous axis,
// four elements per copy where the leading dimension and base allow it
// (`vec`), masked at the ragged edges (zeros outside). An operand is stored either k-inner (rows of the tile's m or n
// index, k contiguous, row pitch kBK + 4) or k-outer (rows of k, m or n
// contiguous, pitch kBM + 8); both pitches spread a fragment's 32 reads
// over the 32 banks and keep rows 16-byte aligned.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace tc {

constexpr int kBM = 64;  // tile rows (m)
constexpr int kBN = 64;  // tile columns (n)
constexpr int kBK = 32;  // k-tile depth
constexpr int kGemmThreads = 128;
constexpr int kPitchIn = kBK + 4;   // k-inner row pitch (floats)
constexpr int kPitchOut = kBM + 8;  // k-outer row pitch (floats)
constexpr int kTileFloats = kBM * kPitchIn;  // = kBK * kPitchOut
static_assert(kBM * kPitchIn == kBK * kPitchOut, "one buffer size");
static_assert(kBM == kBN, "square tiles share the loaders");
// float4 loads per thread for one operand tile
constexpr int kLoads = kBM * kBK / 4 / kGemmThreads;

__device__ __forceinline__ float ld_f(const float* p) { return *p; }
__device__ __forceinline__ float ld_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// four consecutive elements at p (16-byte aligned for float, 8 for bf16)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

// elements [c, c + 4) of a row at p, of which the first `n` exist
template <typename T>
__device__ __forceinline__ float4 ld4_masked(const T* p, int n, bool vec) {
  if (vec && n >= 4) return ld4(p);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = i < n ? ld_f(p + i) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// cp.async of four consecutive floats of which the first n (0-4) exist,
// the rest zero-filled: one 16-byte copy when vec (a 16-byte aligned
// source), else four 4-byte ones; a copy of nothing reads from `base`
__device__ __forceinline__ void cp_async4x(float* dst, const float* src,
                                           int n, bool vec,
                                           const float* base) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(n ? src : base), "r"(4 * n));
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                     d + 4 * i),
                 "l"(i < n ? src + i : base), "r"(i < n ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// The rows of an operand in order: row m of the tile's matrix is row m of
// memory. A row map (m -> memory row) lets a tile gather its rows, each
// still contiguous (K10's column-major image layout).
struct IdentityRows {
  __device__ __forceinline__ int operator()(int m) const { return m; }
};

// One operand tile of 64 rows x 32 contiguous elements: row r of the tile
// is src + map(row0 + r) * ld, elements [c0, c0 + 32) of it; rows from
// `rows` on and elements from `cols` on are zero. Row r, quad q of the
// tile is load slot (r * 8 + q): eight threads read one 128-byte run.
// Stored k-inner: the row is the m / n index, the elements are k.
template <typename T>
struct RowTile {
  float4 v[kLoads];
  template <class Rows = IdentityRows>
  __device__ __forceinline__ void load(const T* src, int ld, int row0,
                                       int rows, int c0, int cols,
                                       bool vec, Rows map = Rows()) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = threadIdx.x + j * kGemmThreads;
      const int r = i / (kBK / 4), c = c0 + (i % (kBK / 4)) * 4;
      v[j] = row0 + r < rows && c < cols
                 ? ld4_masked(src + (size_t)map(row0 + r) * ld + c,
                              cols - c, vec)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void store(float* s) const {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = threadIdx.x + j * kGemmThreads;
      *reinterpret_cast<float4*>(s + (i / (kBK / 4)) * kPitchIn +
                                 (i % (kBK / 4)) * 4) = v[j];
    }
  }
};

// the same tile copied straight into shared memory (fp32 operands)
template <class Rows = IdentityRows>
__device__ __forceinline__ void row_tile_async(float* s, const float* src,
                                               int ld, int row0, int rows,
                                               int c0, int cols, bool vec,
                                               Rows map = Rows()) {
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = threadIdx.x + j * kGemmThreads;
    const int r = i / (kBK / 4), q = (i % (kBK / 4)) * 4, c = c0 + q;
    const int n = row0 + r < rows ? min(max(cols - c, 0), 4) : 0;
    cp_async4x(s + r * kPitchIn + q, src + (size_t)map(row0 + r) * ld + c,
               n, vec, src);
  }
}

// One operand tile of 32 rows (k) x 64 contiguous elements (m or n): row
// k of the tile is src + (k0 + k) * ld, elements [c0, c0 + 64). Sixteen
// threads read one 256-byte run. Stored k-outer.
template <typename T>
struct KTile {
  float4 v[kLoads];
  __device__ __forceinline__ void load(const T* src, int ld, int k0,
                                       int krows, int c0, int cols,
                                       bool vec) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = threadIdx.x + j * kGemmThreads;
      const int k = i / (kBM / 4), c = c0 + (i % (kBM / 4)) * 4;
      v[j] = k0 + k < krows && c < cols
                 ? ld4_masked(src + (size_t)(k0 + k) * ld + c, cols - c,
                              vec)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void store(float* s) const {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = threadIdx.x + j * kGemmThreads;
      *reinterpret_cast<float4*>(s + (i / (kBM / 4)) * kPitchOut +
                                 (i % (kBM / 4)) * 4) = v[j];
    }
  }
};

__device__ __forceinline__ void k_tile_async(float* s, const float* src,
                                             int ld, int k0, int krows,
                                             int c0, int cols, bool vec) {
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = threadIdx.x + j * kGemmThreads;
    const int k = i / (kBM / 4), q = (i % (kBM / 4)) * 4, c = c0 + q;
    const int n = k0 + k < krows ? min(max(cols - c, 0), 4) : 0;
    cp_async4x(s + k * kPitchOut + q, src + (size_t)(k0 + k) * ld + c, n,
               vec, src);
  }
}

// true when rows of pitch `ld` elements of T starting at `p` can be read
// four elements at a time
template <typename T>
__host__ __device__ inline bool vec_ok(const T* p, int ld) {
  return ld % 4 == 0 &&
         reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// element (row, k) of a 64 x 32 operand tile in either layout
template <bool KOUTER>
__device__ __forceinline__ float at(const float* s, int row, int k) {
  return KOUTER ? s[k * kPitchOut + row] : s[row * kPitchIn + k];
}

// acc[mi][ni] (a 16 x 8 fragment each) += the warp's 32 x 32 part of
// As Bs over the first `kmax` (a multiple of 8) of the k-tile; a 16-row
// or 8-column fragment at or past `mrows` / `ncols` (the tile's valid
// extent) is skipped, as is all of the warp's work when none is valid.
// SPLIT: 3xTF32, else 1xTF32.
template <bool A_KOUTER, bool B_KOUTER, bool SPLIT>
__device__ __forceinline__ void warp_mma(const float* As, const float* Bs,
                                         int kmax, int mrows, int ncols,
                                         float (&acc)[2][4][4]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int grp = lane / 4, tig = lane % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  if (wm >= mrows || wn >= ncols) return;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    if (kk >= kmax) break;
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm + mi * 16 + grp;
      const float v[4] = {at<A_KOUTER>(As, r, kk + tig),
                          at<A_KOUTER>(As, r + 8, kk + tig),
                          at<A_KOUTER>(As, r, kk + tig + 4),
                          at<A_KOUTER>(As, r + 8, kk + tig + 4)};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ah[mi][q] = to_tf32(v[q]);
        if (SPLIT) al[mi][q] = to_tf32(v[q] - __uint_as_float(ah[mi][q]));
      }
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = wn + ni * 8 + grp;
      const float v[2] = {at<B_KOUTER>(Bs, c, kk + tig),
                          at<B_KOUTER>(Bs, c, kk + tig + 4)};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        bh[ni][q] = to_tf32(v[q]);
        if (SPLIT) bl[ni][q] = to_tf32(v[q] - __uint_as_float(bh[ni][q]));
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        if (wm + mi * 16 >= mrows || wn + ni * 8 >= ncols) continue;
        if (SPLIT) {
          mma_tf32(acc[mi][ni], al[mi], bh[ni]);
          mma_tf32(acc[mi][ni], ah[mi], bl[ni]);
        }
        mma_tf32(acc[mi][ni], ah[mi], bh[ni]);
      }
  }
}

// visit the warp's outputs: f(row, col, value) with tile-relative row/col
template <typename F>
__device__ __forceinline__ void for_each_out(const float (&acc)[2][4][4],
                                             F&& f) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int grp = lane / 4, tig = lane % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        f(wm + mi * 16 + grp + (q / 2) * 8, wn + ni * 8 + tig * 2 + (q % 2),
          acc[mi][ni][q]);
}

// bf16 operands: the k-loop through registers. load(kt, ta, tb) fills the
// tile registers with k-tile kt of A and B (converted to fp32) and returns
// how many of its k are valid; the products of the block's valid mrows x
// ncols accumulate into acc. Two buffers per operand in shared memory
// (36.9 KB), one barrier per k-tile.
template <bool A_KOUTER, bool B_KOUTER, bool SPLIT, class TA, class TB,
          class Load>
__device__ __forceinline__ void gemm_loop(int ntiles, int mrows, int ncols,
                                          Load&& load,
                                          float (&acc)[2][4][4]) {
  __shared__ __align__(16) float sA[2][kTileFloats];
  __shared__ __align__(16) float sB[2][kTileFloats];
  TA ta;
  TB tb;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
  if (ntiles <= 0) return;
  int kv = load(0, ta, tb);
  ta.store(sA[0]);
  tb.store(sB[0]);
  __syncthreads();
  for (int kt = 0; kt < ntiles; ++kt) {
    const int cur = kt & 1;
    const bool next = kt + 1 < ntiles;
    const int kmax = (min(kv, kBK) + 7) / 8 * 8;
    if (next) kv = load(kt + 1, ta, tb);
    warp_mma<A_KOUTER, B_KOUTER, SPLIT>(sA[cur], sB[cur], kmax, mrows, ncols,
                                        acc);
    if (next) {
      ta.store(sA[cur ^ 1]);
      tb.store(sB[cur ^ 1]);
    }
    __syncthreads();
  }
}

// fp32 operands: the k-loop with kStages tiles of each operand in dynamic
// shared memory (kAsyncSmem bytes), copied by cp.async kStages - 1 tiles
// ahead of the MMAs. start_copy(kt, sA, sB) starts the copies of k-tile kt;
// kvalid(kt) is how many of its k are valid. One barrier per k-tile. Two
// stages: on the H100, 3 and 4 stages ran K5 and K2's projection slower at
// the main path's shapes, as their shared memory lets fewer blocks stay
// resident.
constexpr int kStages = 2;
constexpr size_t kAsyncSmem = sizeof(float) * 2 * kStages * kTileFloats;
static_assert(kAsyncSmem <= 48 * 1024, "no opt-in to large shared memory");

template <bool A_KOUTER, bool B_KOUTER, bool SPLIT, class Copy, class Kv>
__device__ __forceinline__ void gemm_loop_async(int ntiles, int mrows,
                                                int ncols, Copy&& start_copy,
                                                Kv&& kvalid,
                                                float (&acc)[2][4][4]) {
  extern __shared__ __align__(16) float smem_tc[];
  float* sA = smem_tc;
  float* sB = smem_tc + kStages * kTileFloats;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ntiles)
      start_copy(st, sA + st * kTileFloats, sB + st * kTileFloats);
    cp_async_commit();
  }
  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; tile kt - 1 is consumed by all
    const int nt = kt + kStages - 1, st = nt % kStages;
    if (nt < ntiles)
      start_copy(nt, sA + st * kTileFloats, sB + st * kTileFloats);
    cp_async_commit();
    const int cur = kt % kStages;
    warp_mma<A_KOUTER, B_KOUTER, SPLIT>(
        sA + cur * kTileFloats, sB + cur * kTileFloats,
        (min(kvalid(kt), kBK) + 7) / 8 * 8, mrows, ncols, acc);
  }
  cp_async_wait<0>();
}

// One 64 x 64 tile of a chain's projection P = u [W_dt | W_B | W_C]: ub
// is the chain's u (token m at row map(m) of ub, dg values each), wdt its
// W_dt (dg x dg), wbc its [W_B | W_C] (dg x 2N), P its (L x (dg + 2N))
// fp32 rows in token order. Rows m0.. of tokens, column tile ty: tiles
// below ceil(dg / 64) lie in W_dt, the rest in [W_B | W_C], decided once.
// 3xTF32 at fp32 io, exact 1xTF32 at bf16. K10 and K11 call it with the
// same arguments, so K11 recomputes the bits K10 scanned.
template <typename T, class Rows = IdentityRows>
__device__ __forceinline__ void proj_tile(const T* ub, const T* wdt,
                                          const T* wbc, float* P, int L,
                                          int dg, int N, int m0, int ty,
                                          Rows map = Rows()) {
  const int ntd = (dg + kBN - 1) / kBN;
  const bool in_dt = ty < ntd;
  const int n0 = (in_dt ? ty : ty - ntd) * kBN;
  const int nw = in_dt ? dg : 2 * N;
  const int col0 = in_dt ? 0 : dg;
  const T* wb = in_dt ? wdt : wbc;
  const bool vu = vec_ok(ub, dg), vw = vec_ok(wb, nw);
  const int ntiles = (dg + kBK - 1) / kBK;
  float acc[2][4][4];
  if constexpr (std::is_same<T, float>::value) {
    // fp32: 3xTF32, operands copied by cp.async
    gemm_loop_async<false, true, true>(
        ntiles, L - m0, nw - n0,
        [=](int kt, float* sa, float* sb) {
          row_tile_async(sa, ub, dg, m0, L, kt * kBK, dg, vu, map);
          k_tile_async(sb, wb, nw, kt * kBK, dg, n0, nw, vw);
        },
        [=](int kt) { return dg - kt * kBK; }, acc);
  } else {
    // bf16: exact in TF32, converted on the way into shared memory
    gemm_loop<false, true, false, RowTile<T>, KTile<T>>(
        ntiles, L - m0, nw - n0,
        [=](int kt, RowTile<T>& ta, KTile<T>& tb) {
          ta.load(ub, dg, m0, L, kt * kBK, dg, vu, map);
          tb.load(wb, nw, kt * kBK, dg, n0, nw, vw);
          return dg - kt * kBK;
        },
        acc);
  }
  const int kz = dg + 2 * N;
  for_each_out(acc, [&](int r, int c, float v) {
    if (m0 + r < L && n0 + c < nw)
      P[(size_t)(m0 + r) * kz + col0 + n0 + c] = v;
  });
}

// the grid of proj_tile blocks over `chains` chains: (token tiles, column
// tiles, chains)
inline dim3 proj_grid(int L, int dg, int N, int chains) {
  return dim3((L + kBM - 1) / kBM,
              (dg + kBN - 1) / kBN + (2 * N + kBN - 1) / kBN, chains);
}

// dynamic shared memory of a proj_tile block
template <typename T>
constexpr size_t proj_smem() {
  return std::is_same<T, float>::value ? kAsyncSmem : 0;
}

}  // namespace tc
