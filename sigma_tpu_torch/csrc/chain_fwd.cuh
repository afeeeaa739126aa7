// The one-pass chunk scan of K2 (csrc/scan_g_fwd.cu): one exp per (token,
// channel, state), the carries composed in a fixed order. Per chain g,
// channel e, state n:
//     d_t = softplus(dt_t + bias_e)                 (softplus optional)
//     h_t = exp(d_t A_ne) h_{t-1} + d_t u_t B_tn    (fp32 state)
//     y_t = sum_n C_tn h_tn + D_e u_t (+ y_accum_t)
// walked first to last, or last to first in place.
//
// One launch. A block scans one chunk of kChunk = 128 tokens for 8 (16
// states) or 16 (4 or 8 states) channels of one chain (Tile), each warp
// one or two of them, each lane kItems = 4 consecutive walk positions
// (csrc/chunk.cuh's chunks, slots and lane scans). It stages d, u, B and
// C in walk order and, per state, computes the lane's decays a = exp(d A)
// and inputs b = d u B once, folds them, composes the 32 lanes (scan_up),
// and from the lane's exclusive prefix (xa, xb) keeps what the emission
// needs from them:
//     yz_t = sum_n C_tn hz_tn   (hz: the state from a zero carry)
//     K_tn = C_tn prod_{s <= t} a_sn   (the carry's weight in y_t)
// (4 values a lane and (channel, state) slot: 8 slots in registers, the
// rest in the thread's own slots of shared memory), the chunk's map (prod
// a, hz at its end) and the segment entries' (xa, xb) in shared memory.
// Only then does it need the carry h_in entering its chunk, and it emits
//     y_t = yz_t + sum_n K_tn h_in_n + D_e u_t,   hck = xa h_in + xb.
//
// The carries, in a fixed order. The walk's chunks form groups of kGroup =
// 16. A block publishes its chunk's map (prod a, hz_end) for the later
// chunks of its group, composes the maps of the group's earlier chunks,
// first to last (M), and applies M to the state entering the group: h_in =
// M(h_group). The group's last chunk applies its own map to its h_in and
// publishes the state entering the next group. So the carry crosses device
// memory once per group on the critical path (n_chunk / 16 dependent hops,
// not n_chunk), every composition has one order, and y and hck are
// bit-identical on a rerun (no look-back whose order depends on timing).
// Every published value travels in a 64-bit word with its flag (value bits
// low, 1 high), stored and polled relaxed at gpu scope: one aligned 64-bit
// access is single-copy atomic, so a reader that sees the flag sees the
// value, and no fence or barrier sits on the path from one chunk to the
// next. The caller zeroes the words and the ticket counter before every
// launch.
//
// No deadlock: blocks take tickets from a counter as they start
// (atomicAdd), and ticket t is walk chunk t / (chains * n_ctile) of chain
// instance and channel tile t % (chains * n_ctile), so a block only ever
// waits on tickets handed out before its own, to blocks that are running.
//
// Bound: the exps (MUFU, 16 a clock per SM) and the fp32 cores: per
// (token, channel, state) one exp and ~8 fp32 operations, and the lane
// scan's shuffles per (lane, state); the carries add one dependent hop
// through L2 per group of 16 chunks of each (chain, channel tile).
//
// Operand source S (derived from ChainArgs), as csrc/chunk_fwd.cuh's:
//   bool rev(int g); View view(int b, int g) with float u_at(t, e),
//   dt_at(t, e) (raw, before the bias), b_at(t, n), c_at(t, n), void
//   put_y(t, e, v), put_hck(j, n, e, v); float a_at(g, n, e).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "chunk.cuh"

namespace chain {

using chunk::kChunk;
using chunk::kFull;
using chunk::kItems;
using chunk::kRows;
using chunk::kSeg;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;  // threads per block
constexpr int kSegs = kChunk / kSeg;   // checkpoint segments a chunk
constexpr int kSegLanes = kSeg / kItems;
constexpr int kGroup = 16;            // chunks a carry group

struct ChainArgs {
  const float* A;     // (G, N, dg)
  const float* bias;  // (G, dg), may be null
  const float* Dk;    // (G, dg), may be null
  // published words (value, flag), zeroed by the caller:
  unsigned long long* gstate;  // (chains, n_group, N, dg): the state
                               // entering walk group k (k >= 1)
  unsigned long long* maps;    // (chains, n_ctile, n_chunk, 2, NT, kChan):
                               // each walk chunk's map (prod a, hz_end),
                               // n_ctile = ceil(dg / Tile<NT>::kChan)
  int* counter;                // the block tickets, zeroed by the caller
  float* hck;         // may be null
  int G, L, dg, N, softplus, n_chunk;
  __device__ float a_at(int g, int n, int e) const {
    return A[((size_t)g * N + n) * dg + e];
  }
};

// a published value: its bits and the flag 1 in one 64-bit word
__device__ __forceinline__ void publish(unsigned long long* p, float v) {
  const unsigned long long w =
      (1ull << 32) | static_cast<unsigned long long>(__float_as_uint(v));
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(w)
               : "l"(p)
               : "memory");
  return w;
}

// the value of a word once its flag is up (polled from `w`, a first read);
// a wait of seconds is a fault, and the kernel traps rather than hold the
// card
__device__ __forceinline__ float take(const unsigned long long* p,
                                      unsigned long long w) {
  for (long long spin = 0; (w >> 32) == 0; ++spin) {
    if (spin > (1ll << 26)) __trap();
    __nanosleep(32);
    w = peek(p);
  }
  return __uint_as_float(static_cast<unsigned>(w));
}

// A block's channels by its state tile NT: each warp walks kPer channels,
// one after the other (2 below 16 states, so that a block's fixed costs,
// its ticket, staging and carry, spread over more channels), and each
// lane keeps kSlots = kPer NT (channel, state) slots of the carry's
// weights K, kKreg of them in registers and the rest in its own slots of
// shared memory (so that three blocks fit an SM's registers).
template <int NT>
struct Tile {
  static constexpr int kPer = NT == 16 ? 1 : 2;
  static constexpr int kChan = kWarps * kPer;  // channels per block
  static constexpr int kLd = kChan + 1;        // staged channel row pitch
  static constexpr int kSlots = kPer * NT;
  static constexpr int kKreg = kSlots < 8 ? kSlots : 8;
};

__host__ __device__ inline int n_group(int n_chunk) {
  return (n_chunk + kGroup - 1) / kGroup;
}

// The shared memory of a block, in floats: the staged chunk, the tile's A,
// the chunk's map, the carry in, the segment entries' prefixes (CK), and
// the carry's weights K past kKreg, each thread its own slots (72 KB a
// block at 16 states)
template <int NT, bool CK>
struct ChainSmem {
  using Tl = Tile<NT>;
  static constexpr int kLdN = NT + 1;
  static constexpr int kStaged = kRows * Tl::kLd;
  static constexpr int kMap = NT * Tl::kChan;
  static constexpr int kUs = 0;                        // u, then y
  static constexpr int kDs = kUs + kStaged;            // d
  static constexpr int kBs = kDs + kStaged;            // B
  static constexpr int kCs = kBs + kRows * kLdN;       // C
  static constexpr int kAs = kCs + kRows * kLdN;       // A of the tile
  static constexpr int kTa = kAs + kMap;               // the chunk's map
  static constexpr int kTb = kTa + kMap;
  static constexpr int kHin = kTb + kMap;              // the carry in
  static constexpr int kCa = kHin + kMap;              // segment entries'
  static constexpr int kCb = kCa + (CK ? kSegs * kMap : 0);  // xa, xb
  static constexpr int kK = kCb + (CK ? kSegs * kMap : 0);
  static constexpr int kFloats =
      kK + (Tl::kSlots - Tl::kKreg) * kItems * kThreads;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// NT >= N states a block (4, 8 or 16); CK: write the checkpoints
template <class S, int NT, bool CK>
__global__ void __launch_bounds__(kThreads, 3)
chain_scan_kernel(const S p, int chains) {
  using Sm = ChainSmem<NT, CK>;
  using Tl = Tile<NT>;
  constexpr int kLdN = Sm::kLdN, kChan = Tl::kChan, kLd = Tl::kLd;
  extern __shared__ float smem[];
  float* us = smem + Sm::kUs;
  float* ds = smem + Sm::kDs;
  float* bs = smem + Sm::kBs;
  float* cs = smem + Sm::kCs;
  float* as = smem + Sm::kAs;
  float* ta = smem + Sm::kTa;
  float* tb = smem + Sm::kTb;
  float* hin = smem + Sm::kHin;
  float* ca = smem + Sm::kCa;
  float* cb = smem + Sm::kCb;
  float* ks = smem + Sm::kK + threadIdx.x;  // this thread's K slots
  __shared__ int ticket;
  const int dg = p.dg, N = p.N, L = p.L, n_chunk = p.n_chunk;
  const int nct = (dg + kChan - 1) / kChan, ngr = n_group(n_chunk);
  if (threadIdx.x == 0) ticket = atomicAdd(p.counter, 1);
  __syncthreads();
  const int per = chains * nct;
  const int w = ticket / per, z = (ticket % per) / nct, ct = ticket % nct;
  const int g = z % p.G, b = z / p.G;
  const int rev = p.rev(g);
  const int c = rev ? n_chunk - 1 - w : w;  // physical chunk
  const int e0 = ct * kChan;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const auto v = p.view(b, g);

  // stage the chunk in walk order: u, d, B, C and A (zeros past L, dg, N);
  // each thread's loads start together, then their stores
  constexpr int kPerU = kChunk * kChan / kThreads;
  constexpr int kPerB = kChunk * NT / kThreads;
  static_assert(kPerU * kThreads == kChunk * kChan, "whole staging rounds");
  static_assert(kPerB * kThreads == kChunk * NT, "whole staging rounds");
  {
    float uv[kPerU], dv[kPerU];
#pragma unroll
    for (int it = 0; it < kPerU; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int k = i / kChan, e = e0 + i % kChan;
      const int t = chunk::phys(c, k, rev);
      const bool ok = t < L && e < dg;
      uv[it] = ok ? v.u_at(t, e) : 0.f;
      dv[it] = ok ? v.dt_at(t, e) : 0.f;
    }
    const float bias = p.bias && e0 + (int)threadIdx.x % kChan < dg
                           ? p.bias[(size_t)g * dg + e0 + threadIdx.x % kChan]
                           : 0.f;
#pragma unroll
    for (int it = 0; it < kPerU; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int k = i / kChan, ch = i % kChan;
      float d = 0.f;
      if (chunk::phys(c, k, rev) < L && e0 + ch < dg) {
        d = dv[it] + bias;
        if (p.softplus) d = chunk::softplus_f(d);
      }
      us[chunk::slot(k) * kLd + ch] = uv[it];
      ds[chunk::slot(k) * kLd + ch] = d;
    }
  }
  {
    float bv[kPerB], cv[kPerB];
#pragma unroll
    for (int it = 0; it < kPerB; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int k = i / NT, n = i % NT;
      const int t = chunk::phys(c, k, rev);
      const bool ok = t < L && n < N;
      bv[it] = ok ? v.b_at(t, n) : 0.f;
      cv[it] = ok ? v.c_at(t, n) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < kPerB; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int k = i / NT, n = i % NT;
      bs[chunk::slot(k) * kLdN + n] = bv[it];
      cs[chunk::slot(k) * kLdN + n] = cv[it];
    }
  }
  for (int i = threadIdx.x; i < NT * kChan; i += kThreads) {
    const int n = i / kChan, e = e0 + i % kChan;
    as[i] = n < N && e < dg ? p.a_at(g, n, e) : 0.f;
  }
  __syncthreads();

  // the warp's channels warp + kWarps i: per state, the lane's decays and
  // inputs once
  float yk[Tl::kPer][kItems], K[Tl::kKreg][kItems];
#pragma unroll
  for (int ci = 0; ci < Tl::kPer; ++ci) {
    const int ch = warp + kWarps * ci;
    float dk[kItems], uk[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int r = chunk::slot(lane * kItems + j) * kLd + ch;
      dk[j] = ds[r];
      uk[j] = us[r];
      yk[ci][j] = 0.f;
    }
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += 2) {
      float ak[2][kItems], bk[2][kItems], fa[2], fb[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float an = as[(n0 + q) * kChan + ch];
        fa[q] = 1.f;
        fb[q] = 0.f;
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const int r = chunk::slot(lane * kItems + j) * kLdN + n0 + q;
          ak[q][j] = __expf(dk[j] * an);
          bk[q][j] = dk[j] * uk[j] * bs[r];
          fb[q] = fmaf(ak[q][j], fb[q], bk[q][j]);
          fa[q] *= ak[q][j];
        }
      }
      chunk::scan_up<2>(fa, fb, lane);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = n0 + q, slot = ci * NT + n;
        // exclusive prefix: the map from the chunk's entry to this lane
        float xa = __shfl_up_sync(kFull, fa[q], 1);
        float xb = __shfl_up_sync(kFull, fb[q], 1);
        if (lane == 0) {
          xa = 1.f;
          xb = 0.f;
        }
        if (lane == 31) {
          ta[n * kChan + ch] = fa[q];
          tb[n * kChan + ch] = fb[q];
        }
        if (CK && lane % kSegLanes == 0) {
          ca[((lane / kSegLanes) * NT + n) * kChan + ch] = xa;
          cb[((lane / kSegLanes) * NT + n) * kChan + ch] = xb;
        }
        float h = xb, pr = xa;
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const float cv = cs[chunk::slot(lane * kItems + j) * kLdN + n];
          h = fmaf(ak[q][j], h, bk[q][j]);
          pr *= ak[q][j];
          yk[ci][j] = fmaf(cv, h, yk[ci][j]);
          if (slot < Tl::kKreg)
            K[slot < Tl::kKreg ? slot : 0][j] = cv * pr;
          else
            ks[((slot - Tl::kKreg) * kItems + j) * kThreads] = cv * pr;
        }
      }
    }
  }
  __syncthreads();

  // the carry: this chunk's map for the group's later chunks, the maps of
  // its earlier chunks composed first to last, the state entering the group
  constexpr int kMap = Sm::kMap;
  const size_t tile = (size_t)z * nct + ct;  // (chain instance, channel tile)
  unsigned long long* maps = p.maps + tile * n_chunk * 2 * kMap;
  const int grp = w / kGroup, g0 = grp * kGroup;
  const bool tail = w - g0 == kGroup - 1;  // the group's last chunk
  const int i = threadIdx.x;  // thread i < kMap: state i / kChan, channel
  if (i < kMap) {
    if (!tail && w + 1 < n_chunk) {
      publish(maps + (size_t)w * 2 * kMap + i, ta[i]);
      publish(maps + (size_t)w * 2 * kMap + kMap + i, tb[i]);
    }
    // the earlier chunks' maps, four read at a time
    float ma = 1.f, mb = 0.f;
    for (int r0 = g0; r0 < w; r0 += 4) {
      unsigned long long qa[4], qb[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (r0 + q < w) {
          qa[q] = peek(maps + (size_t)(r0 + q) * 2 * kMap + i);
          qb[q] = peek(maps + (size_t)(r0 + q) * 2 * kMap + kMap + i);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (r0 + q < w) {
          const unsigned long long* pm = maps + (size_t)(r0 + q) * 2 * kMap;
          const float a = take(pm + i, qa[q]);
          mb = fmaf(a, mb, take(pm + kMap + i, qb[q]));
          ma *= a;
        }
      }
    }
    const int n = i / kChan, e = e0 + i % kChan;
    const bool ok = n < N && e < dg;
    unsigned long long* gs =
        p.gstate + (((size_t)z * ngr + grp) * N + n) * dg + e;
    const float hg = ok && grp > 0 ? take(gs, peek(gs)) : 0.f;
    const float h = fmaf(ma, hg, mb);
    hin[i] = h;
    if (ok && tail && w + 1 < n_chunk)
      publish(gs + (size_t)N * dg, fmaf(ta[i], h, tb[i]));
  }
  __syncthreads();

  // the emission from the carry: y into us (the warp's own columns), hck
#pragma unroll
  for (int ci = 0; ci < Tl::kPer; ++ci) {
    const int ch = warp + kWarps * ci, e = e0 + ch;
    const float d_e = p.Dk && e < dg ? p.Dk[(size_t)g * dg + e] : 0.f;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int r = chunk::slot(lane * kItems + j) * kLd + ch;
      float y = yk[ci][j];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int slot = ci * NT + n;
        const float kn =
            slot < Tl::kKreg
                ? K[slot < Tl::kKreg ? slot : 0][j]
                : ks[((slot - Tl::kKreg) * kItems + j) * kThreads];
        y = fmaf(kn, hin[n * kChan + ch], y);
      }
      us[r] = fmaf(d_e, us[r], y);
    }
  }
  if (CK) {
    // segment s starts at walk position s kSeg: physical token phys(c, s
    // kSeg) lies in checkpoint segment phys / kSeg (reversed, a segment
    // past L - 1 is entered at L - 1 with the same state; one wholly past L
    // does not exist)
    const int n_ck = chunk::n_ck_of(L);
    for (int i = threadIdx.x; i < kSegs * N * kChan; i += kThreads) {
      const int s = i / (N * kChan), n = (i / kChan) % N, cc = i % kChan;
      const int jj = chunk::phys(c, s * kSeg, rev) / kSeg;
      const int idx = (s * NT + n) * kChan + cc;
      if (jj < n_ck && e0 + cc < dg)
        v.put_hck(jj, n, e0 + cc, fmaf(ca[idx], hin[n * kChan + cc], cb[idx]));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kChunk * kChan; i += kThreads) {
    const int k = i / kChan, cc = i % kChan, ee = e0 + cc;
    const int t = chunk::phys(c, k, rev);
    if (t < L && ee < dg) v.put_y(t, ee, us[chunk::slot(k) * kLd + cc]);
  }
}

// one launch over `chains` = batch * G chain instances; the published
// words and the counter zeroed by the caller
template <class S, int NT, bool CK>
int launch_chain(const S& p, int chains, cudaStream_t stream) {
  constexpr size_t bytes = ChainSmem<NT, CK>::kBytes;
  auto kernel = chain_scan_kernel<S, NT, CK>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t blocks = (size_t)chains * p.n_chunk *
                        ((p.dg + Tile<NT>::kChan - 1) / Tile<NT>::kChan);
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(p,
                                                                    chains);
  return static_cast<int>(cudaGetLastError());
}

template <class S, int NT>
int launch_chain_scan(const S& p, int chains, cudaStream_t stream) {
  return p.hck ? launch_chain<S, NT, true>(p, chains, stream)
               : launch_chain<S, NT, false>(p, chains, stream);
}

}  // namespace chain
