// CSR SpMM for Hopper: out = A @ H, in column slabs of H sized to the L2.
//
// Replaces the Pallas TPU kernel `spmm_bcsr` (_spmm_kernel) of
// src/repro/kernels/spmm.py.  The function is the same, Â @ H in f32; only
// the format changes, from the TPU's dense 8x128 tiles to CSR:
//   indptr  (N+1,)  int32   row pointers
//   indices (nnz,)  int32   column of each nonzero
//   values  (nnz,)  f32     value of each nonzero
//   h       H (N, D), or its slab-major copy (slabs, N, w): row r of slab s
//           starts at h + s * h_slab + r * h_row; every index < N
//   out     (N, D)  f32
//   items   (2, n_items) int32 or null: the row split (row, first nonzero)
//           of every work item, for graphs with rows above kSeg nonzeros
//   partial (2 * (n_items - N), slabs * w) f32 and arrivals
//           (n_items - N, slabs) int32 zeros: scratch of the split rows
//           (null when items is null)
//
// Why CSR.  On a 16,384-node SBM graph the 8x128 tiles are 0.3% full and
// every row block holds tiles in every column block: the tile format moves
// ~1 GB of zeros for 3.2 MB of nonzeros.  No tensor cores: A is 0.3% dense,
// so an MMA tile would multiply zeros, and the 1e-5 parity contract rules
// out TF32.
//
// What bounds it.  The work is a gather: each nonzero reads a row of H for
// as many FMAs as floats, ~0.25 FMA per byte gathered, far from the f32
// rate.  The bound is the gathers: how many lines they touch, where those
// lines are served from, and how many are in flight.  On the LLCG
// benchmark's graph (232,965 rows, 23.2 M nonzeros) H is 238 MB at
// D = 256 and 561 MB at D = 602, against 50 MB of L2; gathered across all
// of D at once, a pass's footprint (119 MB at D = 256) is mostly HBM.
//
// Column slabs.  Where H does not fit half of the L2, or a row of it is
// no whole number of 16-byte loads (spmm.py `slab_plan`), the launch
// splits D into slabs of one 128-byte line, 32 floats, and makes one pass
// per slab (grid.y; blocks are dispatched x first, so slab after slab over
// all rows).  A pass then gathers from one line of every row, 29.8 MB at
// 232,965 rows, which stays in L2, and each gather is a whole line; the
// cost is the index stream, read again each pass.  Measured on the H100
// at that graph, one-line slabs beat the narrower slabs that fit half of
// the L2 (16 floats: 14.9 MB, but half a line a gather) by ~25%, and beat
// them at every row count up to 650,000 (83 MB); the lane split across all
// of D takes ~1.7x as long.  Where a row of H is no whole number of lines
// (D % 32 != 0) a slab's floats would straddle lines, so the host first
// packs H into a slab-major copy (spmm_csr_kernel_pack, counted with the
// SpMM's time) and gathers from that; the pack also gives float4 loads
// where D % 4 != 0, so the kernel has no scalar path.  Where all of H fits
// half of the L2 and its rows are whole float4s, one launch gathers
// straight from H with as many lanes as D needs, up to 32 float4 lanes a
// pass: there slabs save no HBM traffic, and the index stream read once a
// slab costs time at narrow D and on skewed rows (measured: the lane split
// within 4% of one-line slabs at D 32-256, 8-21% faster at D 16 and with
// 16 hubs of 4,096 nonzeros; past the switch, slabs 3% slower at 65,536
// rows and 14-28% faster from 100,000).
// L2 eviction hints (evict_first on the index stream, evict_last on the
// gathers) were measured slower here and are not used.
//
// Lanes.  A group of G lanes owns one output row and covers the pass's
// w = 4 G columns with 16-byte (float4) loads.  A warp holds 32/G rows.
// The group reads its row's indices and values in coalesced batches of at
// least 16 and broadcasts them with __shfl_sync; 4 gathers a lane are in
// flight before their FMAs, and blocks are held to 64 registers a thread,
// so an SM runs 32 warps: at the benchmark's shape the gathers are bound
// by how many are in flight, and more warps hide more of their latency
// than more loads a lane do.  The sum stays in f32 registers in the row's
// order: each output is one fmaf chain over its row's nonzeros, whatever
// the plan.  No atomics on the sum, so the card repeats itself run to run.
//
// Long rows.  One group walks a row in order, so a hub of thousands of
// nonzeros would hold one group for thousands of dependent gathers while
// the rest of the card idles.  The host splits every row above kSeg = 128
// nonzeros (over twice the mean degree of the graphs the port runs) into
// work items of kSeg: each item is one group's work, as long as an
// ordinary row.  An item of a split row writes its partial sum to
// `partial`; the last item of the row to arrive (an atomic counter per
// split row and slab, not on the data) adds the partials in item order and
// writes the row.  The sum order is fixed again; only graphs with such
// rows pay the scratch and the counters.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;           // blocks an SM holds: 32 warps, 64 registers
constexpr int kSeg = 128;               // nonzeros per work item of a split row
constexpr int kBatch = 16;              // least nonzeros a group reads at once
constexpr int kFlight = 4;              // gathers a lane has in flight
constexpr int kSlab = 32;               // floats of a packed slab: one line

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 acc) {
  return make_float4(fmaf(a, x.x, acc.x), fmaf(a, x.y, acc.y),
                     fmaf(a, x.z, acc.z), fmaf(a, x.w, acc.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// the first `valid` of the four columns: one 16-byte store where the
// output row is 16-byte aligned and all four are in it
__device__ __forceinline__ void store4(float* p, float4 v, int valid,
                                       bool aligned) {
  if (aligned && valid >= 4) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  p[0] = v.x;
  if (valid > 1) p[1] = v.y;
  if (valid > 2) p[2] = v.z;
  if (valid > 3) p[3] = v.w;
}

template <int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
spmm_csr_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                const float* __restrict__ values, const int* __restrict__ items,
                const float* __restrict__ h, float* __restrict__ out,
                float* __restrict__ partial, int* __restrict__ arrivals,
                int n_items, int d, long long h_row, long long h_slab) {
  constexpr int W = G * 4;                      // columns of a pass
  constexpr int B = G < kBatch ? kBatch : G;    // nonzeros a group reads at once
  constexpr int J = B / G;                      // of them, each lane's
  const int lane = threadIdx.x & 31;
  const int g_lane = lane % G;
  const unsigned gmask = G == 32 ? 0xffffffffu
                                 : ((1u << G) - 1u) << (lane - g_lane);
  const long long item = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
  if (item >= n_items) return;          // uniform across the group
  const int slab = blockIdx.y;
  const int col = slab * W + g_lane * 4;        // the lane's first output column
  const bool has_col = col < d;
  const float* hs = h + slab * h_slab + g_lane * 4;

  const int row = items != nullptr ? items[item] : (int)item;
  const int row_lo = indptr[row], row_hi = indptr[row + 1];
  const bool split = items != nullptr && row_hi - row_lo > kSeg;
  const int lo = items != nullptr ? items[n_items + item] : row_lo;
  const int hi = split ? min(lo + kSeg, row_hi) : row_hi;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int base = lo; base < hi; base += B) {
    int my_col[J];
    float my_val[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e = base + j * G + g_lane;
      my_col[j] = 0;
      my_val[j] = 0.f;
      if (e < hi) {
        my_col[j] = __ldg(indices + e);
        my_val[j] = __ldg(values + e);
      }
    }
    const int cnt = min(B, hi - base);
#pragma unroll
    for (int k0 = 0; k0 < B; k0 += kFlight) {
      if (k0 >= cnt) break;             // uniform across the group
      int c[kFlight];
      float a[kFlight];
#pragma unroll
      for (int i = 0; i < kFlight; ++i) {
        c[i] = __shfl_sync(gmask, my_col[(k0 + i) / G], (k0 + i) % G, G);
        a[i] = __shfl_sync(gmask, my_val[(k0 + i) / G], (k0 + i) % G, G);
      }
      if (has_col) {
        float4 x[kFlight];
#pragma unroll
        for (int i = 0; i < kFlight; ++i) {
          if (k0 + i < cnt) {
            x[i] = __ldg(reinterpret_cast<const float4*>(hs + c[i] * h_row));
          }
        }
#pragma unroll
        for (int i = 0; i < kFlight; ++i) {
          if (k0 + i < cnt) acc = fma4(a[i], x[i], acc);
        }
      }
    }
  }

  const bool aligned = d % 4 == 0;
  float* dst = out + (long long)row * d + col;
  if (!split) {
    if (has_col) store4(dst, acc, d - col, aligned);
    return;
  }
  // a split row: publish this item's partial, and the last item to arrive
  // sums the row's partials in item order.  The row's first item is
  // row + e, e the extra items of the split rows before it; e differs
  // between split rows and each has two parts or more, so 2e + part names
  // every split item's partial once, below 2 * (n_items - N).
  const int part = (lo - row_lo) / kSeg;
  const long long e = item - part - row;
  const int n_parts = (row_hi - row_lo + kSeg - 1) / kSeg;
  const long long stride = (long long)gridDim.y * W;
  if (has_col) {
    __stcg(reinterpret_cast<float4*>(partial + (2 * e + part) * stride + col),
           acc);
  }
  __threadfence();
  __syncwarp(gmask);
  int last = 0;
  if (g_lane == 0) {
    last = atomicAdd(arrivals + e * gridDim.y + slab, 1) == n_parts - 1;
  }
  last = __shfl_sync(gmask, last, 0, G);
  if (!last || !has_col) return;
  __threadfence();
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = 0; p < n_parts; ++p) {
    sum = add4(sum, __ldcg(reinterpret_cast<const float4*>(
                        partial + (2 * e + p) * stride + col)));
  }
  store4(dst, sum, d - col, aligned);
}

// H (N, D) into its slab-major copy (slabs, N, kSlab), zeros past D: a
// warp reads one row of H in order and writes each slab's kSlab floats of
// it.
__global__ void __launch_bounds__(kThreads)
spmm_csr_kernel_pack(const float* __restrict__ h, float* __restrict__ packed,
                     int n, int d, int slabs) {
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
  if (row >= n) return;
  const int lane = threadIdx.x & 31;
  const float* src = h + row * d;
  float* dst = packed + row * kSlab;
  for (int j = lane; j < slabs * kSlab; j += 32) {
    dst[(long long)(j / kSlab) * n * kSlab + j % kSlab] =
        j < d ? __ldg(src + j) : 0.f;
  }
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `lanes` (a power of two up to 32) lanes share a row, each loading a
// float4, so a pass covers w = 4 * lanes columns; `slabs` passes (grid.y)
// cover D.  h, out and partial are 16-byte aligned, h_row and h_slab
// multiples of 4.
extern "C" int spmm_csr_f32(const int* indptr, const int* indices,
                            const float* values, const int* items,
                            const float* h, float* out, float* partial,
                            int* arrivals, int n_items, int d,
                            long long h_row, long long h_slab, int lanes,
                            int slabs, void* stream) {
  if (n_items == 0 || d == 0) return 0;
  if (d < 0 || n_items < 0 || slabs < 1 || slabs > 65535 ||
      4LL * slabs * lanes < d || reinterpret_cast<uintptr_t>(h) % 16 != 0 ||
      h_row % 4 != 0 || h_slab % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long threads = (long long)n_items * lanes;
  dim3 grid((unsigned)((threads + kThreads - 1) / kThreads), slabs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SPMM_CASE(G_)                                                        \
  case G_:                                                                   \
    spmm_csr_kernel<G_><<<grid, kThreads, 0, s>>>(                           \
        indptr, indices, values, items, h, out, partial, arrivals, n_items,  \
        d, h_row, h_slab);                                                   \
    break;
  switch (lanes) {
    SPMM_CASE(1) SPMM_CASE(2) SPMM_CASE(4) SPMM_CASE(8) SPMM_CASE(16)
    SPMM_CASE(32)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPMM_CASE
  return static_cast<int>(cudaGetLastError());
}

// Packs H (N, D) into `packed` (slabs, N, 32), zeros past D; on `stream`,
// returning the cudaError_t of the launch.
extern "C" int spmm_csr_pack_f32(const float* h, float* packed, int n, int d,
                                 int slabs, void* stream) {
  if (n == 0 || d == 0) return 0;
  if (n < 0 || d < 0 || slabs < 1 || (long long)slabs * kSlab < d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = (unsigned)(((long long)n * 32 + kThreads - 1) / kThreads);
  spmm_csr_kernel_pack<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(h, packed, n, d,
                                                              slabs);
  return static_cast<int>(cudaGetLastError());
}
