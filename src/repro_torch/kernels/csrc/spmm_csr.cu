// CSR SpMM for Hopper: out = A @ H, a group of lanes per row.
//
// Replaces the Pallas TPU kernel `spmm_bcsr` (_spmm_kernel) of
// src/repro/kernels/spmm.py.  The function is the same, Â @ H in f32; only
// the format changes, from the TPU's dense 8x128 tiles to CSR:
//   indptr  (N+1,)  int32   row pointers
//   indices (nnz,)  int32   column of each nonzero
//   values  (nnz,)  f32     value of each nonzero
//   h       (N, D)  f32     every index < N
//   out     (N, D)  f32
//   items   (2, n_items) int32 or null: the row split (row, first nonzero)
//           of every work item, for graphs with rows above kSeg nonzeros
//   partial (n_items, D) f32 and arrivals (N * n_slabs,) int32 zeros:
//           scratch of the split rows (null when items is null)
//
// Why CSR.  On a 16,384-node SBM graph the 8x128 tiles are 0.3% full and
// every row block holds tiles in every column block: the tile format moves
// ~1 GB of zeros for 3.2 MB of nonzeros.  The work is a gather: each
// nonzero reads one row of H (4·D bytes) for D FMAs, ~0.25 FMA per byte
// gathered.  H (4-8 MB at that shape) stays in the 50 MB L2, so the bound
// is the gather's L2 traffic and the latency of the dependent loads, far
// from the f32 rate.  No tensor cores: A is 0.3% dense, so an MMA tile
// would multiply zeros, and the 1e-5 parity contract rules out TF32.
//
// Design.  A group of G lanes owns one output row and covers D with 16-byte
// (float4) loads when D % 4 == 0: G = 8 at D = 32, 16 at D = 64, 32 at
// D = 128 (scalar loads otherwise; D above 32 float4s takes more column
// slabs, blockIdx.y).  A warp holds 32/G rows.  The group reads its row's
// indices and values in coalesced batches of G and broadcasts them with
// __shfl_sync; the H rows come through the read-only path, four loads in
// flight before their FMAs, and the sum stays in f32 registers in the
// row's order.  No atomics on the sum, so the card repeats itself run to
// run.
//
// Long rows.  One group walks a row in order, so a hub of thousands of
// nonzeros would hold one group for thousands of dependent gathers while
// the rest of the card idles.  The host splits every row above kSeg = 128
// nonzeros (over twice the mean degree of the graphs the port runs) into
// work items of kSeg: each item is one group's work, as long as an
// ordinary row.  An item of a split row writes its partial sum to
// `partial`; the last item of the row to arrive (an atomic counter per
// row, not on the data) adds the partials in item order and writes the
// row.  The sum order is fixed again; only graphs with such rows pay the
// scratch and the counters.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSeg = 128;               // nonzeros per work item of a split row

template <int VEC> struct Vec;
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ T fma(float a, T x, T acc) {
    return make_float4(fmaf(a, x.x, acc.x), fmaf(a, x.y, acc.y),
                       fmaf(a, x.z, acc.z), fmaf(a, x.w, acc.w));
  }
  static __device__ __forceinline__ T add(T a, T b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
};
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T fma(float a, T x, T acc) { return fmaf(a, x, acc); }
  static __device__ __forceinline__ T add(T a, T b) { return a + b; }
};

template <int VEC, int G>
__global__ void __launch_bounds__(kThreads)
spmm_csr_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                const float* __restrict__ values, const int* __restrict__ items,
                const float* __restrict__ h, float* __restrict__ out,
                float* __restrict__ partial, int* __restrict__ arrivals,
                int n_items, int d) {
  using V = Vec<VEC>;
  using T = typename V::T;
  const int lane = threadIdx.x & 31;
  const int g_lane = lane % G;
  const unsigned gmask = G == 32 ? 0xffffffffu
                                 : ((1u << G) - 1u) << (lane - g_lane);
  const long long item = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
  if (item >= n_items) return;          // uniform across the group
  const int col = (blockIdx.y * G + g_lane) * VEC;
  const bool has_col = col < d;

  const int row = items != nullptr ? items[item] : (int)item;
  const int row_lo = indptr[row], row_hi = indptr[row + 1];
  const bool split = items != nullptr && row_hi - row_lo > kSeg;
  const int lo = items != nullptr ? items[n_items + item] : row_lo;
  const int hi = split ? min(lo + kSeg, row_hi) : row_hi;

  T acc = V::zero();
  for (int base = lo; base < hi; base += G) {
    int my_col = 0;
    float my_val = 0.f;
    if (base + g_lane < hi) {
      my_col = __ldg(indices + base + g_lane);
      my_val = __ldg(values + base + g_lane);
    }
    const int cnt = min(G, hi - base);
    int k = 0;
    for (; k + 4 <= cnt; k += 4) {
      int c[4];
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        c[i] = __shfl_sync(gmask, my_col, k + i, G);
        a[i] = __shfl_sync(gmask, my_val, k + i, G);
      }
      if (has_col) {
        T x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i] = __ldg(reinterpret_cast<const T*>(h + (long long)c[i] * d + col));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) acc = V::fma(a[i], x[i], acc);
      }
    }
    for (; k < cnt; ++k) {
      const int c = __shfl_sync(gmask, my_col, k, G);
      const float a = __shfl_sync(gmask, my_val, k, G);
      if (has_col) {
        acc = V::fma(a, __ldg(reinterpret_cast<const T*>(h + (long long)c * d + col)), acc);
      }
    }
  }

  T* dst = reinterpret_cast<T*>(out + (long long)row * d + col);
  if (!split) {
    if (has_col) *dst = acc;
    return;
  }
  // a split row: publish this item's partial, and the last item to arrive
  // sums the row's partials in item order
  const long long first = item - (lo - row_lo) / kSeg;
  const int n_parts = (row_hi - row_lo + kSeg - 1) / kSeg;
  if (has_col) __stcg(reinterpret_cast<T*>(partial + item * d + col), acc);
  __threadfence();
  __syncwarp(gmask);
  int last = 0;
  if (g_lane == 0) {
    last = atomicAdd(arrivals + (long long)row * gridDim.y + blockIdx.y, 1) ==
           n_parts - 1;
  }
  last = __shfl_sync(gmask, last, 0, G);
  if (!last || !has_col) return;
  __threadfence();
  T sum = V::zero();
  for (int p = 0; p < n_parts; ++p) {
    sum = V::add(sum, __ldcg(reinterpret_cast<const T*>(
                          partial + (first + p) * d + col)));
  }
  *dst = sum;
}

template <int VEC>
int launch(const int* indptr, const int* indices, const float* values,
           const int* items, const float* h, float* out, float* partial,
           int* arrivals, int n_items, int d, int g, int slabs,
           cudaStream_t stream) {
  const long long threads = (long long)n_items * g;
  dim3 grid((unsigned)((threads + kThreads - 1) / kThreads), slabs);
#define SPMM_CASE(G_)                                                        \
  case G_:                                                                   \
    spmm_csr_kernel<VEC, G_><<<grid, kThreads, 0, stream>>>(                 \
        indptr, indices, values, items, h, out, partial, arrivals, n_items,  \
        d);                                                                  \
    break;
  switch (g) {
    SPMM_CASE(1) SPMM_CASE(2) SPMM_CASE(4) SPMM_CASE(8) SPMM_CASE(16)
    SPMM_CASE(32)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPMM_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The column slabs the launch needs: grid.y of spmm_csr_f32, and so the
// row count of `arrivals` per row.  vec4 != 0 takes float4 loads.
extern "C" int spmm_csr_slabs(int d, int vec4) {
  const int per_lane = vec4 ? 4 : 1;
  const int lanes = (d + per_lane - 1) / per_lane;
  return (lanes + 31) / 32;
}

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// vec4 != 0 needs D % 4 == 0 and 16-byte aligned h, out and partial.
extern "C" int spmm_csr_f32(const int* indptr, const int* indices,
                            const float* values, const int* items,
                            const float* h, float* out, float* partial,
                            int* arrivals, int n_items, int d, int vec4,
                            void* stream) {
  if (n_items == 0 || d == 0) return 0;
  if (d < 0 || n_items < 0 || (vec4 && d % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_lane = vec4 ? 4 : 1;
  const int lanes = (d + per_lane - 1) / per_lane;
  int g = 1;
  while (g < lanes && g < 32) g *= 2;
  const int slabs = spmm_csr_slabs(d, vec4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec4 ? launch<4>(indptr, indices, values, items, h, out, partial,
                          arrivals, n_items, d, g, slabs, s)
              : launch<1>(indptr, indices, values, items, h, out, partial,
                          arrivals, n_items, d, g, slabs, s);
}
