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
// Bound.  Quantize reads 8 bytes (4 without u) and writes 1 per element, a
// few operations each: bound by memory traffic.  At the averaging shapes
// ((8, C), C <= 4096, 64-256 KB a call) no shape moves enough bytes to
// matter; the time is launch and the latency of the dependent steps (load,
// row max, scale, quantize, store), so the design cuts those steps and
// spreads a row over enough SMs that each thread makes one or two loads.
//
// Design (quantize).  The host picks the geometry (quantize.geometry in
// kernels/quantize.py holds the thresholds and their reasons):
// - A row is read in "loads" of VEC floats: 16-byte float4 loads when
//   C % 4 == 0 and x, u are 16-byte aligned, else scalar loads.  Thread l of
//   the L threads serving a row takes loads l, l + L, l + 2L, ...; the first
//   SLOTS of them stay in registers (x and u, all issued before the first is
//   used) from the max to the quantize step, so x is read from device memory
//   once.  Loads past SLOTS * L (rows above 8 * 512 * 8 loads, which no path
//   of the port has) are streamed: read for the max and read again to
//   quantize.  q is stored four bytes at a time on the float4 path.
// - kGroup (narrow rows): a group of `lanes` lanes (a power of two <= 32)
//   of one warp per row, several rows per CTA; the max reduces by
//   __shfl_xor within the group alone: no shared memory, no __syncthreads.
// - kBlock (wide rows, many of them): one CTA per row; warp shuffles, one
//   shared-memory slot per warp and one __syncthreads.
// - kCluster (wide rows, few of them): a row split over a thread-block
//   cluster of up to 8 CTAs.  Each warp pushes its partial max into a slot
//   of every CTA's shared memory (distributed shared memory stores), one
//   cluster barrier (release/acquire) publishes them, and each CTA then
//   reduces its own copy: no CTA touches another's shared memory after the
//   barrier, so a CTA may exit at once.  A relaxed arrival at the start,
//   waited on once the loads are in flight, guarantees that every CTA of
//   the cluster is running before another writes into its shared memory.
// Every thread of a row computes the same scale from the same max; the one
// thread with l == 0 writes it.
//
// Dequantize runs a (row, column chunk) grid, so each thread knows its row
// without dividing its index.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 512;
constexpr int kMaxRowWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 8;

enum Mode { kGroup = 0, kBlock = 1, kCluster = 2 };

template <int VEC> struct Vec;
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ T fill(float v) {
    return make_float4(v, v, v, v);
  }
  static __device__ __forceinline__ float absmax(T v) {
    return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
  }
};
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ T fill(float v) { return v; }
  static __device__ __forceinline__ float absmax(T v) { return fabsf(v); }
};

__device__ __forceinline__ int8_t quant(float x, float u, float s) {
  const float v = floorf(__fdiv_rn(x, s) + u);
  return static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
}

__device__ __forceinline__ void store(int8_t* q, float4 x, float4 u,
                                      float s) {
  *reinterpret_cast<char4*>(q) = make_char4(quant(x.x, u.x, s),
                                            quant(x.y, u.y, s),
                                            quant(x.z, u.z, s),
                                            quant(x.w, u.w, s));
}
__device__ __forceinline__ void store(int8_t* q, float x, float u, float s) {
  *q = quant(x, u, s);
}

struct QuantArgs {
  const float* x;
  const float* u;       // null: 0.5 everywhere
  int8_t* q;
  float* scale;
  int r, c;
  int lanes;            // lanes of a warp per row (kGroup), else 32
  int row_warps;        // warps of a CTA per row (1 in kGroup)
  int cta_rows;         // rows per CTA (1 unless kGroup)
  int cluster;          // CTAs per row (kCluster), else 1
};

template <int VEC, int SLOTS, int MODE>
__global__ void __launch_bounds__(kMaxThreads)
quantize_rows_kernel(const QuantArgs a) {
  using V = Vec<VEC>;
  using T = typename V::T;
  __shared__ float part[MODE == kGroup ? 1 : kMaxCluster * kMaxRowWarps];
  const int t = threadIdx.x;
  const int span = a.lanes * a.row_warps;        // threads of a CTA per row
  const int rank = MODE == kCluster
                       ? static_cast<int>(cg::this_cluster().block_rank())
                       : 0;
  const long long row =
      static_cast<long long>(blockIdx.x / a.cluster) * a.cta_rows + t / span;
  const int step = a.cluster * span;             // threads per row
  const int l = rank * span + t % span;
  const int n = a.c / VEC;                       // loads per row
  // a thread past the last row stays for the group's shuffles
  const bool live = row < a.r;
  const float* xr = a.x + row * a.c;
  const float* ur = a.u != nullptr ? a.u + row * a.c : nullptr;
  if (MODE == kCluster) {
    // this CTA is running: another may write into its shared memory once it
    // has waited for this arrival (after its loads are issued)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }

  T xv[SLOTS], uv[SLOTS];
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {              // every load issued first
    const int v = l + i * step;
    xv[i] = V::fill(0.f);
    uv[i] = V::fill(0.5f);
    if (live && v < n) {
      xv[i] = V::load(xr + v * VEC);
      if (ur != nullptr) uv[i] = V::load(ur + v * VEC);
    }
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) amax = fmaxf(amax, V::absmax(xv[i]));
  for (int v = l + SLOTS * step; live && v < n; v += step) {
    amax = fmaxf(amax, V::absmax(V::load(xr + v * VEC)));
  }

  if (MODE == kGroup) {                          // the group's lanes alone
    for (int o = a.lanes / 2; o > 0; o >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    }
  } else {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    }
    const int warp = t / 32, lane = t % 32;
    if (MODE == kCluster) {
      // every CTA of the cluster is running (the arrival at the start) ...
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
      // ... so lane k hands this warp's max to CTA k, and one barrier
      // publishes the pushes
      if (lane < a.cluster) {
        *cg::this_cluster().map_shared_rank(
            &part[rank * a.row_warps + warp], static_cast<unsigned>(lane)) =
            amax;
      }
      __syncwarp();
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    } else {
      if (lane == 0) part[warp] = amax;
      __syncthreads();
    }
    const int parts = a.cluster * a.row_warps;
    amax = part[0];
    for (int i = 1; i < parts; ++i) amax = fmaxf(amax, part[i]);
  }
  if (!live) return;

  // (float)1e-12 is the double 1e-12 rounded to f32, as PyTorch and JAX
  // round the Python constant
  const float s = __fdiv_rn(fmaxf(amax, (float)1e-12), 127.0f);
  if (l == 0) a.scale[row] = s;
  int8_t* qr = a.q + row * a.c;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int v = l + i * step;
    if (v < n) store(qr + v * VEC, xv[i], uv[i], s);
  }
  for (int v = l + SLOTS * step; v < n; v += step) {
    store(qr + v * VEC, V::load(xr + v * VEC),
          ur != nullptr ? V::load(ur + v * VEC) : V::fill(0.5f), s);
  }
}

template <int VEC, int SLOTS, int MODE>
int launch_quantize(const QuantArgs& a, int threads, int grid,
                    cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (MODE == kCluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, quantize_rows_kernel<VEC, SLOTS, MODE>, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <int VEC, int MODE>
int launch_slots(const QuantArgs& a, int slots, int threads, int grid,
                 cudaStream_t stream) {
  switch (slots) {
    case 1: return launch_quantize<VEC, 1, MODE>(a, threads, grid, stream);
    case 2: return launch_quantize<VEC, 2, MODE>(a, threads, grid, stream);
    case 4: return launch_quantize<VEC, 4, MODE>(a, threads, grid, stream);
    case 8: return launch_quantize<VEC, 8, MODE>(a, threads, grid, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int VEC>
int launch_mode(const QuantArgs& a, int mode, int slots, int threads,
                int grid, cudaStream_t stream) {
  switch (mode) {
    case kGroup:
      return launch_slots<VEC, kGroup>(a, slots, threads, grid, stream);
    case kBlock:
      return launch_slots<VEC, kBlock>(a, slots, threads, grid, stream);
    default:
      return launch_slots<VEC, kCluster>(a, slots, threads, grid, stream);
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

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `u` may be null.  The geometry (quantize.geometry) comes from the host:
// vec (4 needs C % 4 == 0 and 16-byte aligned x and u), lanes of a warp per
// row, warps per row, rows per CTA, CTAs per row (a cluster above 1), loads
// per thread kept in registers, and the grid.
extern "C" int quantize_rows_f32(const float* x, const float* u, int8_t* q,
                                 float* scale, int r, int c, int vec,
                                 int lanes, int row_warps, int cta_rows,
                                 int cluster, int slots, int grid,
                                 void* stream) {
  if (r == 0 || c == 0) return 0;
  const int threads = cta_rows * lanes * row_warps;
  const bool group = row_warps == 1 && cluster == 1;
  if (r < 0 || c < 0 || (vec != 1 && vec != 4) || c % vec != 0 ||
      lanes < 1 || 32 % lanes != 0 ||
      (!group && (lanes != 32 || cta_rows != 1)) ||
      threads % 32 != 0 || threads > kMaxThreads || cluster < 1 ||
      cluster > kMaxCluster || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const QuantArgs a{x, u, q, scale, r, c, lanes, row_warps, cta_rows, cluster};
  const int mode = cluster > 1 ? kCluster : (group ? kGroup : kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec == 4 ? launch_mode<4>(a, mode, slots, threads, grid, s)
                  : launch_mode<1>(a, mode, slots, threads, grid, s);
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
