// Row-wise symmetric int8 quantize / dequantize for Hopper: the wire format
// of the compressed communication layer.
//
// Replaces the Pallas TPU kernels `quantize_rows` (_quantize_kernel) and
// `dequantize_rows` (_dequantize_kernel) of src/repro/kernels/quantize.py.
// The operand contract is the same:
//   quantize:   x (R, C) f32, u (R, C) f32 or null (null = 0.5, i.e.
//               round-half-up)  ->  q (R, C) int8, scale (R, 1) f32 with
//               scale = max(max|x[r]|, 1e-12) / 127 and
//               q = clip(floor(x / scale + u), -127, 127)
//   dequantize: q (R, C) int8, scale (R, 1) f32  ->  out (R, C) f32 = q*scale
//
// Bit-exactness.  Both divisions go through __fdiv_rn, the correctly rounded
// f32 quotient, so the result never depends on -prec-div or fast-math flags,
// and nothing computes x * (1/scale).  The row max is order-independent and
// the add and floor are single f32 operations, so q and scale are bit-equal
// to the plain PyTorch version (repro_torch/kernels/ref.py), whose CUDA
// division is correctly rounded too.
//
// Design.  The TPU kernel quantizes a (128-row, whole-C) block per grid
// step.  Here one CTA owns one row: a strided pass takes max|x| into a
// register per thread, warp shuffles and one shared-memory slot per warp
// reduce it, thread 0 writes the scale, and a second strided pass quantizes
// the row (re-reading it from L1/L2).  Dequantize runs a (row, column
// chunk) grid, so each thread knows its row without dividing its index.
//
// Bound.  Both kernels do a few operations per byte they move (quantize
// reads 8 bytes and writes 1 per element), so they are bound by memory
// traffic, far below the f32 rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__global__ void quantize_rows_kernel(const float* __restrict__ x,
                                     const float* __restrict__ u,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ scale, int c) {
  __shared__ float warp_amax[32];
  __shared__ float row_scale;
  const long long base = (long long)blockIdx.x * c;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  float amax = 0.f;
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    amax = fmaxf(amax, fabsf(x[base + j]));
  }
  amax = warp_max(amax);
  if (lane == 0) warp_amax[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    float m = lane < (int)(blockDim.x / 32) ? warp_amax[lane] : 0.f;
    m = warp_max(m);
    if (lane == 0) {
      // (float)1e-12 is the double 1e-12 rounded to f32, as PyTorch and JAX
      // round the Python constant
      const float s = __fdiv_rn(fmaxf(m, (float)1e-12), 127.0f);
      row_scale = s;
      scale[blockIdx.x] = s;
    }
  }
  __syncthreads();

  const float s = row_scale;
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    const float uu = u != nullptr ? u[base + j] : 0.5f;
    float v = floorf(__fdiv_rn(x[base + j], s) + uu);
    v = fminf(fmaxf(v, -127.f), 127.f);
    q[base + j] = static_cast<int8_t>(v);
  }
}

__global__ void dequantize_rows_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ scale,
                                       float* __restrict__ out, int c) {
  const long long base = (long long)blockIdx.x * c;
  const float s = scale[blockIdx.x];
  for (int j = blockIdx.y * blockDim.x + threadIdx.x; j < c;
       j += gridDim.y * blockDim.x) {
    out[base + j] = static_cast<float>(q[base + j]) * s;
  }
}

// threads per CTA for a row of c values: whole warps, at most 256
int row_threads(int c) { return c >= 256 ? 256 : ((c + 31) / 32) * 32; }

}  // namespace

// Each entry launches on `stream` and returns the cudaError_t of the launch
// (0 = ok).  `u` may be null.
extern "C" int quantize_rows_f32(const float* x, const float* u, int8_t* q,
                                 float* scale, int r, int c, void* stream) {
  if (r == 0 || c == 0) return 0;
  quantize_rows_kernel<<<r, row_threads(c), 0,
                         static_cast<cudaStream_t>(stream)>>>(x, u, q, scale,
                                                              c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequantize_rows_f32(const int8_t* q, const float* scale,
                                   float* out, int r, int c, void* stream) {
  if (r == 0 || c == 0) return 0;
  const int threads = row_threads(c);
  int chunks = (c + threads - 1) / threads;
  if (chunks > 65535) chunks = 65535;          // grid.y limit; the loop covers
  dequantize_rows_kernel<<<dim3(r, chunks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(q, scale, out,
                                                                c);
  return static_cast<int>(cudaGetLastError());
}
