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
// Design (dequantize).  Reads 1 byte and writes 4 per value, one multiply:
// bound by memory traffic at (65536, 256); at the averaging shapes by the
// launch, of which config C used to make one per parameter leaf.  So one
// launch serves a table of up to 32 segments (q, scale, out, R, C), passed
// by value as a __grid_constant__ parameter (no copy to the device): each
// CTA finds its segment in the table's prefix of per-segment tile counts
// (uniform over the CTA) and covers one tile of 2,048 values with 128
// threads, so a small segment takes one CTA or part of one, an averaging
// leaf of (8, 4096) 16 CTAs on as many SMs, and (65536, 256) 8,192 CTAs.  A warp takes a span of 512 contiguous values: each lane
// loads 16 of them with one 16-byte load, the warp passes them through
// shared memory, and each lane then writes four float4 stores, each of the
// warp's stores 512 contiguous bytes (four whole 128-byte lines).  A
// store's four values take their row from their index in the segment: at
// most one row change among them when C >= 4, so one division and two
// scale loads per four values, all issued with the 16-byte load (one round
// trip to memory, not two).  A q that is not 16-byte aligned, a segment's
// last partial span and rows of 1-3 values take byte loads and scalar
// stores, a lane a value, every load before the first store.  The host builds
// the table (quantize.segment_table) and its flat output, each segment's
// output 16-byte aligned.  float(q) * scale is one exact conversion and one
// correctly rounded multiply, as in the plain version: bit-equal.
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

// ---- dequantize: one launch over a table of segments
constexpr int kDeqThreads = 128;
constexpr int kChunk = 16;                   // int8 values a 16-byte load brings
constexpr unsigned kSpan = 32 * kChunk;      // a warp's 16-byte loads: 512 values
constexpr unsigned kTile = kDeqThreads * kChunk;  // a CTA's: 2,048 values
constexpr int kMaxSegments = 32;

// One dequantize: out (r, c) f32 = q (r, c) int8 * scale (r, 1) f32, all
// contiguous; out 16-byte aligned, q any alignment.
struct Segment {
  const int8_t* q;
  const float* scale;
  float* out;
  int r, c;
};

// The launch's segments, passed by value: CTA b serves segment s where
// start[s] <= b < start[s + 1], as its tile b - start[s] of kTile values
// (the last tile cut at r * c).
struct SegmentTable {
  Segment seg[kMaxSegments];
  int start[kMaxSegments + 1];
  int count;
};
static_assert(sizeof(SegmentTable) <= 4096,
              "a kernel's parameters are limited to 4 KB");

// value k (0..3) of the four packed little-endian in w, sign-extended
__device__ __forceinline__ float byte_at(int w, int k) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * k)));
}

__global__ void __launch_bounds__(kDeqThreads)
dequantize_rows_kernel(const __grid_constant__ SegmentTable tab) {
  __shared__ int4 stage[kDeqThreads];
  const int b = blockIdx.x;
  int s = 0;                                   // the same for the whole CTA
  while (s + 1 < tab.count && b >= tab.start[s + 1]) ++s;
  const Segment& g = tab.seg[s];
  const unsigned c = static_cast<unsigned>(g.c);
  const unsigned n = static_cast<unsigned>(g.r) * c;  // < 2^31 (host check)
  const unsigned lane = threadIdx.x % 32;
  // warp w of the CTA takes values base .. base + 511 of its segment
  const unsigned base =
      static_cast<unsigned>(b - tab.start[s]) * kTile + threadIdx.x / 32 * kSpan;
  if (base >= n) return;                       // the warp has nothing
  if ((reinterpret_cast<uintptr_t>(g.q) & 15) != 0 || base + kSpan > n ||
      c < 4) {
    // unaligned q, the segment's last partial span or rows of 1-3 values:
    // a lane a value, every load issued before the first store
    int8_t qv[kChunk];
    float sv[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (base + 32 * j >= n) break;           // the same for the whole warp
      const unsigned i = base + 32 * j + lane;
      qv[j] = 0;
      sv[j] = 0.f;
      if (i < n) {
        qv[j] = g.q[i];
        sv[j] = __ldg(g.scale + i / c);
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (base + 32 * j >= n) break;
      const unsigned i = base + 32 * j + lane;
      if (i < n) g.out[i] = static_cast<float>(qv[j]) * sv[j];
    }
    return;
  }
  const int4 w = __ldg(reinterpret_cast<const int4*>(g.q + base) + lane);
  // this lane's store m writes values base + 4 (32 m + lane) .. + 3: at most
  // one row change among them (C >= 4), after `left[m]` of the four; their
  // scales are loaded while the 16-byte load is in flight (straight-line
  // code, so no branch holds them back behind the shared-memory store)
  float s0[4], s1[4];
  unsigned left[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const unsigned i = base + 4 * (32 * m + lane);
    const unsigned row = i / c;
    left[m] = c - (i - row * c);
    s0[m] = __ldg(g.scale + row);
    s1[m] = __ldg(g.scale + row + (left[m] < 4 ? 1 : 0));
  }
  // lane v / 4 loaded the four values of word v % 4 of its 16 bytes
  stage[threadIdx.x] = w;
  __syncwarp();
  const int* words = reinterpret_cast<const int*>(stage + threadIdx.x / 32 * 32);
  float4* out = reinterpret_cast<float4*>(g.out + base);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const unsigned v = 32 * m + lane;
    const int word = words[v];
    float sc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[j] = j < left[m] ? s0[m] : s1[m];
    out[v] = make_float4(byte_at(word, 0) * sc[0], byte_at(word, 1) * sc[1],
                         byte_at(word, 2) * sc[2], byte_at(word, 3) * sc[3]);
  }
}

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

// One launch over `count` (1..32) segments.  Segment s is q = ptrs[3s],
// scale = ptrs[3s + 1], out = ptrs[3s + 2] (16-byte aligned), r = dims[2s],
// c = dims[2s + 1], with r * c in [1, 2^31); start holds the prefix of the
// segments' tiles of 2,048 values (quantize.segment_table), checked here.
extern "C" int dequantize_rows_grouped_f32(const void* const* ptrs,
                                           const int* dims, const int* start,
                                           int count, void* stream) {
  if (count < 1 || count > kMaxSegments || start[0] != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SegmentTable tab = {};
  tab.count = count;
  for (int s = 0; s < count; ++s) {
    const int r = dims[2 * s], c = dims[2 * s + 1];
    const long long n = static_cast<long long>(r) * c;
    const Segment g{static_cast<const int8_t*>(ptrs[3 * s]),
                    static_cast<const float*>(ptrs[3 * s + 1]),
                    static_cast<float*>(const_cast<void*>(ptrs[3 * s + 2])),
                    r, c};
    if (r < 1 || c < 1 || n >= (1LL << 31) || g.q == nullptr ||
        g.scale == nullptr || g.out == nullptr ||
        (reinterpret_cast<uintptr_t>(g.out) & 15) != 0 ||
        start[s + 1] - start[s] != (n + kTile - 1) / kTile) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    tab.seg[s] = g;
    tab.start[s] = start[s];
  }
  tab.start[count] = start[count];
  dequantize_rows_kernel<<<start[count], kDeqThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(tab);
  return static_cast<int>(cudaGetLastError());
}
