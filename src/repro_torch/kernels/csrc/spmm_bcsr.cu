// Block-sparse (BCSR) SpMM for Hopper: out = A @ H over 8x128 tiles.
//
// Replaces the Pallas TPU kernel `spmm_bcsr` (_spmm_kernel) of
// src/repro/kernels/spmm.py.  The operand contract is the same:
//   tile_cols (n_rb, max_t)           int32  column-block id per tile
//   tile_vals (n_rb, max_t, 8, 128)   f32    dense tile contents
//   h         (n_h, D)                f32    rows past n_h read as zero
//   out       (n_rb * 8, D)           f32
// Padding tiles carry all-zero values, so they add nothing.
//
// Design.  The TPU kernel walks a (row block, D block, tile) grid in order
// and accumulates into one VMEM output block.  Here one CTA owns one
// (row block, 32-column D slab) and loops over the row block's tiles itself:
// per tile it stages the 8x128 tile (4 KB) and the gathered 128x32 slab of H
// (16 KB) in shared memory, then each of its 256 threads accumulates one
// output element in a register with 128 f32 FMAs.  Staging H once per CTA
// lets the 8 rows of the tile share each H element.  No tensor cores: the
// parity contract is full f32.
//
// Bound.  Every tile value is read once and feeds 32 FMAs per slab, so the
// kernel is bound by memory traffic (tile values plus the H slabs it
// gathers), not by the f32 rate.
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 8;
constexpr int kBN = 128;
constexpr int kBD = 32;                 // D columns per CTA
constexpr int kThreads = kBM * kBD;     // one output element per thread

__global__ void __launch_bounds__(kThreads)
spmm_bcsr_kernel(const int* __restrict__ tile_cols,
                 const float* __restrict__ tile_vals,
                 const float* __restrict__ h,
                 float* __restrict__ out,
                 int max_t, int n_h, int d) {
  __shared__ __align__(16) float tile[kBM * kBN];
  __shared__ float slab[kBN * kBD];

  const int rb = blockIdx.x;
  const int d0 = blockIdx.y * kBD;
  const int tid = threadIdx.x;
  const int m = tid / kBD;              // output row inside the row block
  const int j = tid % kBD;              // output column inside the slab
  float acc = 0.f;

  for (int k = 0; k < max_t; ++k) {
    const long long t = (long long)rb * max_t + k;
    const int col_block = tile_cols[t];
    // the tile: 1024 floats, one float4 per thread
    const float4* src = reinterpret_cast<const float4*>(tile_vals + t * (kBM * kBN));
    reinterpret_cast<float4*>(tile)[tid] = src[tid];
    // the H slab: rows col_block*128 .. +127, columns d0 .. d0+31
    for (int e = tid; e < kBN * kBD; e += kThreads) {
      const int n = e / kBD;
      const int c = e % kBD;
      const long long row = (long long)col_block * kBN + n;
      slab[e] = (row < n_h && d0 + c < d) ? h[row * d + d0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 16
    for (int n = 0; n < kBN; ++n) {
      acc = fmaf(tile[m * kBN + n], slab[n * kBD + j], acc);
    }
    __syncthreads();
  }
  if (d0 + j < d) {
    out[((long long)rb * kBM + m) * d + d0 + j] = acc;
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int spmm_bcsr_f32(const int* tile_cols, const float* tile_vals,
                             const float* h, float* out, int n_rb, int max_t,
                             int n_h, int d, void* stream) {
  if (n_rb == 0 || d == 0) return 0;
  dim3 grid(n_rb, (d + kBD - 1) / kBD);
  spmm_bcsr_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tile_cols, tile_vals, h, out, max_t, n_h, d);
  return static_cast<int>(cudaGetLastError());
}
