// Fused masked edge-softmax aggregation (the GAT hotspot) for Hopper.
//
// Replaces the Pallas TPU kernel `edge_softmax` (_edge_softmax_kernel) of
// src/repro/kernels/edge_softmax.py.  The function is the same:
//   scores (N, F) f32, mask (N, F) f32, vals (N, F, D) f32  ->  out (N, D)
//   out[n] = sum_f a[n,f] * vals[n,f,:],
//   a = exp(s - max) * m / max(sum_f exp(s - max) * m, 1e-30)
// where masked slots (m <= 0) score -1e30 inside the max, so a fully masked
// row gives 0.  All math is f32.
//
// Bound.  Every score, mask and value is read once and each value takes one
// FMA: ~0.5 FMA per byte, so memory traffic bounds it (the values are
// 4·F·D of every row's 4·(2F + F·D + D) bytes).  At the main path's shapes
// (800 rows, F 10 or 57, D 64 or 8: 0.3-12 MB a call) no call moves enough
// bytes to matter; the time is launch and the latency of the dependent
// steps, so the design issues every load of a row before the first is
// consumed, and keeps 800 warps in flight.
//
// Design.  One warp per row (4 rows per 128-thread CTA: 800 rows are 800
// warps on 200 CTAs).
// - Values: the warp covers (slot, column) pairs with 16-byte loads when
//   D % 4 == 0 (scalar loads otherwise): LS = D/4 rounded up to a power of
//   two (at most 32) lanes per slot, 32/LS slots per pass — 2 lanes per slot
//   at D 8, 16 at D 64 — so no lane idles at D 8.  D above 128 takes column
//   slabs of 32 float4s, one after another.
// - The first kUnroll passes' value loads are issued before the scores are
//   read; later groups of kUnroll passes are issued together before any of
//   them is consumed.  F 10 at D 64 is 5 passes, F 57 at D 8 is 4: a whole
//   row in flight at once.  Longer rows loop.
// - Scores and mask: lane j reads slots j, j + 32 (coalesced, once for
//   F <= 64); the max and the sum reduce by shuffles, and each slot's weight
//   is computed once, by the lane that read it.  A pass takes its slots'
//   weights from those lanes with one __shfl_sync.  Past 64 slots the
//   weights come in windows of 64, recomputed from the scores and mask of
//   the window (read again, from L1).
// - Each lane sums its slots' a·v in f32 registers; the slot positions then
//   combine by __shfl_xor in a fixed tree.  No atomics: the card gives the
//   same bits on every run.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;          // rows per CTA
constexpr int kRegBlocks = 2;      // 32-slot blocks of weights in registers
constexpr int kWindow = 32 * kRegBlocks;
constexpr int kUnroll = 8;         // passes whose loads are in flight at once

template <int VEC> struct Vec;
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ T fma(float a, T x, T acc) {
    return make_float4(fmaf(a, x.x, acc.x), fmaf(a, x.y, acc.y),
                       fmaf(a, x.z, acc.z), fmaf(a, x.w, acc.w));
  }
  static __device__ __forceinline__ T shfl_add(T v, int o) {
    return make_float4(v.x + __shfl_xor_sync(0xffffffffu, v.x, o),
                       v.y + __shfl_xor_sync(0xffffffffu, v.y, o),
                       v.z + __shfl_xor_sync(0xffffffffu, v.z, o),
                       v.w + __shfl_xor_sync(0xffffffffu, v.w, o));
  }
};
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ T fma(float a, T x, T acc) {
    return fmaf(a, x, acc);
  }
  static __device__ __forceinline__ T shfl_add(T v, int o) {
    return v + __shfl_xor_sync(0xffffffffu, v, o);
  }
};

// a slot's score with the mask applied: -1e30 where masked, as the reference
__device__ __forceinline__ float masked(float s, float m) {
  return m > 0.f ? s : -1e30f;
}

template <int VEC, int LS>
__global__ void __launch_bounds__(kWarps * 32)
edge_softmax_kernel(const float* __restrict__ scores,
                    const float* __restrict__ mask,
                    const float* __restrict__ vals, float* __restrict__ out,
                    int n, int f, int d) {
  using V = Vec<VEC>;
  using T = typename V::T;
  constexpr int kSpp = 32 / LS;                  // slots per pass
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n) return;                          // uniform across the warp
  const int slot = lane / LS, cl = lane % LS;
  const int dc = d / VEC;                        // loads per value row
  const float* sr = scores + row * f;
  const float* mr = mask + row * f;
  const float* vr = vals + row * f * d;

  // the values of passes p0 .. p0 + kUnroll - 1 of window w0, slab c0
  T v[kUnroll];
  auto load_group = [&](int c0, int w0, int p0) {
    const int col = c0 + cl;
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int p = p0 + i;
      const int fs = w0 + p * kSpp + slot;
      v[i] = V::zero();
      if (p * kSpp < kWindow && fs < f && col < dc) {
        v[i] = V::load(vr + (long long)fs * d + col * VEC);
      }
    }
  };
  load_group(0, 0, 0);                           // in flight during the softmax

  // scores and mask of the first window, once; the max and the sum
  float e[kRegBlocks], mk[kRegBlocks];
  float mx = -INFINITY;
#pragma unroll
  for (int b = 0; b < kRegBlocks; ++b) {
    const int j = b * 32 + lane;
    mk[b] = 0.f;
    e[b] = -INFINITY;
    if (j < f) {
      mk[b] = mr[j];
      e[b] = masked(sr[j], mk[b]);
    }
    mx = fmaxf(mx, e[b]);
  }
  for (int j = kWindow + lane; j < f; j += 32) {
    mx = fmaxf(mx, masked(sr[j], mr[j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  float sum = 0.f;
#pragma unroll
  for (int b = 0; b < kRegBlocks; ++b) {
    e[b] = b * 32 + lane < f ? expf(e[b] - mx) * mk[b] : 0.f;
    sum += e[b];
  }
  for (int j = kWindow + lane; j < f; j += 32) {
    const float m = mr[j];
    sum += expf(masked(sr[j], m) - mx) * m;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float denom = fmaxf(sum, 1e-30f);

  for (int c0 = 0; c0 < dc; c0 += LS) {          // column slabs (D > 128)
    const int col = c0 + cl;
    T acc = V::zero();
    for (int w0 = 0; w0 < f; w0 += kWindow) {
      // lane j holds the weight of slot w0 + 32b + j in a[b]
      float a[kRegBlocks];
#pragma unroll
      for (int b = 0; b < kRegBlocks; ++b) {
        const int j = w0 + b * 32 + lane;
        if (w0 == 0) {
          a[b] = e[b] / denom;
        } else {
          const float m = j < f ? mr[j] : 0.f;
          a[b] = j < f ? expf(masked(sr[j], m) - mx) * m / denom : 0.f;
        }
      }
      const int passes = (min(kWindow, f - w0) + kSpp - 1) / kSpp;
      for (int p0 = 0; p0 < passes; p0 += kUnroll) {
        if (c0 != 0 || w0 != 0 || p0 != 0) load_group(c0, w0, p0);
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
          const int p = p0 + i;
          if (p < passes) {                      // uniform across the warp
            // a pass's slots lie in one 32-slot block: kSpp divides 32
            const int ws = p * kSpp;
            float src = a[0];
#pragma unroll
            for (int b = 1; b < kRegBlocks; ++b) {
              if (ws / 32 == b) src = a[b];
            }
            const float w = __shfl_sync(0xffffffffu, src, (ws + slot) & 31);
            acc = V::fma(w, v[i], acc);
          }
        }
      }
    }
    // the slot positions of each column, combined in a fixed order
#pragma unroll
    for (int o = LS; o < 32; o <<= 1) acc = V::shfl_add(acc, o);
    if (slot == 0 && col < dc) {
      *reinterpret_cast<T*>(out + row * d + col * VEC) = acc;
    }
  }
}

template <int VEC>
int launch(const float* scores, const float* mask, const float* vals,
           float* out, int n, int f, int d, cudaStream_t stream) {
  const int dc = d / VEC;
  int ls = 1;
  while (ls < dc && ls < 32) ls *= 2;
  const dim3 grid((n + kWarps - 1) / kWarps);
#define ESM_CASE(LS_)                                                      \
  case LS_:                                                                \
    edge_softmax_kernel<VEC, LS_><<<grid, kWarps * 32, 0, stream>>>(       \
        scores, mask, vals, out, n, f, d);                                 \
    break;
  switch (ls) {
    ESM_CASE(1) ESM_CASE(2) ESM_CASE(4) ESM_CASE(8) ESM_CASE(16)
    ESM_CASE(32)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ESM_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// vec4 != 0 takes float4 loads of vals and stores of out: it needs
// D % 4 == 0 and both 16-byte aligned.
extern "C" int edge_softmax_f32(const float* scores, const float* mask,
                                const float* vals, float* out, int n, int f,
                                int d, int vec4, void* stream) {
  if (n == 0 || d == 0) return 0;
  if (n < 0 || f < 0 || d < 0 || (vec4 && d % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec4 ? launch<4>(scores, mask, vals, out, n, f, d, s)
              : launch<1>(scores, mask, vals, out, n, f, d, s);
}
