// Chunked gated linear scan for Hopper: the compute core of RWKV6 (strict
// convention) and Mamba2's SSD (plain convention).
//
// Replaces the Pallas TPU kernel `linear_scan_chunked` (_make_scan_kernel)
// of src/repro/kernels/linear_scan.py.  Per batch·head, with h in R^{dk x dv}:
//   h_t = diag(w_t) h_{t-1} + k_t v_t^T,   w_t = exp(log_w_t)
//   plain:  y_t = h_t^T q_t
//   strict: y_t = h_{t-1}^T q_t + (q_t . (u (*) k_t)) v_t
// Operands (all f32, contiguous): q, k, log_w (BH, T, dk); v (BH, T, dv);
// h0 (BH, dk, dv) or null (zeros); u (BH, dk) or null (no bonus; strict
// only).  Outputs y (BH, T, dv) and h_T (BH, dk, dv).  T % chunk == 0 and
// chunk, dk, dv <= 64 (the wrapper pads T and checks the rest).
//
// Form.  The reference's factored chunk form, unchanged: within a chunk of L
// steps, P_t = exp(cumsum log_w), Q~ = Q (*) P (P_{t-1} when strict),
// K~ = K (/) P,
//   A      = mask(Q~ K~^T)               (s <= t; s < t when strict)
//   y      = A V + Q~ h_in  (+ bonus)
//   h_out  = diag(P_L) h_in + (K~ (*) P_L)^T V
// so it is finite exactly where the reference is (P^-1 overflows f32 once a
// chunk's summed |log_w| passes ~88.7, in both).
//
// Design.  The TPU grid (BH, n_chunks) carries h in VMEM scratch across its
// sequential chunk axis.  Hopper blocks run in no order, so one CTA owns one
// batch·head and loops over its chunks, with the state in shared memory for
// the whole sequence.  Per chunk: load the q, k, v, log_w tiles; the bonus
// (one thread per row); the decay cumsum and the P scaling (one thread per
// key column, in place); then three 64x64 products on 256 threads, each
// thread holding a 4x4 register tile strided by 16 (A; y with h_out's
// reduction beside it).  Rows are padded to 65 floats, so both row and
// column walks are free of bank conflicts.  ~84 KB of dynamic shared
// memory: above 48 KB, hence cudaFuncSetAttribute before the first launch.
//
// Bound.  Per chunk and head 2(L^2 dk + L^2 dv + 2 L dk dv) f32 operations
// against 4 (3 dk + 2 dv) L bytes read and written: ~26 operations per
// byte at 64/64/64, above the card's f32 ridge (67 TFLOP/s over 3.35 TB/s
// = 20), so the f32 rate, not memory, bounds it.  This first version runs
// FMA loops from shared memory (about one load per two FMAs): tensor-core
// tiles are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kMax = 64;                 // chunk, dk and dv are at most this
constexpr int kStride = kMax + 1;        // padded row: no bank conflicts
constexpr int kTile = kMax * kStride;
constexpr int kThreads = 256;            // 16 x 16, a 4x4 tile each
constexpr size_t kSmemBytes = (5 * kTile + 3 * kMax) * sizeof(float);

template <bool kStrict>
__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ log_w,
                   const float* __restrict__ h0, const float* __restrict__ u,
                   float* __restrict__ y, float* __restrict__ h_out,
                   int t_len, int dk, int dv, int chunk) {
  extern __shared__ float smem[];
  float* sq = smem;                // q, then q~
  float* sk = sq + kTile;          // k, then k~
  float* sv = sk + kTile;          // v
  float* sa = sv + kTile;          // log_w, then the masked L x L product
  float* sh = sa + kTile;          // the state, dk x dv
  float* sp = sh + kTile;          // P_L per key column
  float* sb = sp + kMax;           // bonus per row
  float* su = sb + kMax;           // u

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long bh = blockIdx.x;
  const float* qb = q + bh * t_len * dk;
  const float* kb = k + bh * t_len * dk;
  const float* lb = log_w + bh * t_len * dk;
  const float* vb = v + bh * t_len * dv;
  float* yb = y + bh * t_len * dv;
  const bool bonus = kStrict && u != nullptr;

  for (int i = tid; i < dk * dv; i += kThreads) {
    sh[(i / dv) * kStride + i % dv] =
        h0 != nullptr ? h0[bh * dk * dv + i] : 0.f;
  }
  if (bonus && tid < dk) su[tid] = u[bh * dk + tid];

  for (int c0 = 0; c0 < t_len; c0 += chunk) {
    for (int i = tid; i < chunk * dk; i += kThreads) {
      const int r = i / dk, c = i % dk;
      const long long g = (long long)(c0 + r) * dk + c;
      sq[r * kStride + c] = qb[g];
      sk[r * kStride + c] = kb[g];
      sa[r * kStride + c] = lb[g];
    }
    for (int i = tid; i < chunk * dv; i += kThreads) {
      const int r = i / dv, c = i % dv;
      sv[r * kStride + c] = vb[(long long)(c0 + r) * dv + c];
    }
    __syncthreads();

    if (bonus) {                    // from the raw q and k, before scaling
      if (tid < chunk) {
        float s = 0.f;
        for (int j = 0; j < dk; ++j) {
          s += sq[tid * kStride + j] * su[j] * sk[tid * kStride + j];
        }
        sb[tid] = s;
      }
      __syncthreads();
    }

    if (tid < dk) {                 // decay cumsum down one key column
      const int j = tid;
      float cum = 0.f;
      for (int r = 0; r < chunk; ++r) {
        const float lw = sa[r * kStride + j];
        cum += lw;
        sq[r * kStride + j] *= kStrict ? expf(cum - lw) : expf(cum);
        sk[r * kStride + j] *= expf(-cum);
      }
      sp[j] = expf(cum);
    }
    __syncthreads();

    {                               // A = mask(q~ k~^T), L x L
      float acc[4][4] = {};
      for (int j = 0; j < dk; ++j) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sq[(ty + 16 * i) * kStride + j];
#pragma unroll
        for (int n = 0; n < 4; ++n) b[n] = sk[(tx + 16 * n) * kStride + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int n = 0; n < 4; ++n) acc[i][n] = fmaf(a[i], b[n], acc[i][n]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int r = ty + 16 * i, s = tx + 16 * n;
          if (r < chunk && s < chunk) {
            const bool keep = kStrict ? s < r : s <= r;
            sa[r * kStride + s] = keep ? acc[i][n] : 0.f;
          }
        }
    }
    __syncthreads();

    float ya[4][4] = {};            // y rows ty+16i, columns tx+16n
    float ha[4][4] = {};            // (k~ P_L)^T V: rows (key) ty+16i
    float pl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = ty + 16 * i;
      pl[i] = j < dk ? sp[j] : 0.f;
    }
    for (int s = 0; s < chunk; ++s) {
      float a[4], kk[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sa[(ty + 16 * i) * kStride + s];
        kk[i] = sk[s * kStride + ty + 16 * i] * pl[i];
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) b[n] = sv[s * kStride + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          ya[i][n] = fmaf(a[i], b[n], ya[i][n]);
          ha[i][n] = fmaf(kk[i], b[n], ha[i][n]);
        }
    }
    for (int j = 0; j < dk; ++j) {  // + q~ h_in
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sq[(ty + 16 * i) * kStride + j];
#pragma unroll
      for (int n = 0; n < 4; ++n) b[n] = sh[j * kStride + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n) ya[i][n] = fmaf(a[i], b[n], ya[i][n]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int r = ty + 16 * i, c = tx + 16 * n;
        if (r < chunk && c < dv) {
          float out = ya[i][n];
          if (bonus) out += sb[r] * sv[r * kStride + c];
          yb[(long long)(c0 + r) * dv + c] = out;
        }
      }
    __syncthreads();                // every read of this chunk's tiles is done

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int j = ty + 16 * i, c = tx + 16 * n;
        if (j < dk && c < dv) {
          sh[j * kStride + c] = pl[i] * sh[j * kStride + c] + ha[i][n];
        }
      }
    // the next chunk writes only sq/sk/sv/sa before its first barrier, and
    // reads sh only after it, so no barrier is needed here
  }
  __syncthreads();
  for (int i = tid; i < dk * dv; i += kThreads) {
    h_out[bh * dk * dv + i] = sh[(i / dv) * kStride + i % dv];
  }
}

constexpr int kMaxDevices = 64;

template <bool kStrict>
int launch(const float* q, const float* k, const float* v, const float* log_w,
           const float* h0, const float* u, float* y, float* h_out, int bh,
           int t, int dk, int dv, int chunk, cudaStream_t stream) {
  // the shared-memory opt-in, once per device: later launches may be
  // inside a CUDA-graph capture, where only stream work belongs
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(linear_scan_kernel<kStrict>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = true;
  }
  linear_scan_kernel<kStrict><<<bh, kThreads, kSmemBytes, stream>>>(
      q, k, v, log_w, h0, u, y, h_out, t, dk, dv, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// h0 and u may be null; u is read only when strict != 0.
extern "C" int linear_scan_chunked_f32(const float* q, const float* k,
                                       const float* v, const float* log_w,
                                       const float* h0, const float* u,
                                       float* y, float* h_out, int bh, int t,
                                       int dk, int dv, int chunk, int strict,
                                       void* stream) {
  if (chunk < 1 || chunk > kMax || dk < 1 || dk > kMax || dv < 1 ||
      dv > kMax || t % chunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bh == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return strict ? launch<true>(q, k, v, log_w, h0, u, y, h_out, bh, t, dk, dv,
                               chunk, s)
                : launch<false>(q, k, v, log_w, h0, u, y, h_out, bh, t, dk,
                                dv, chunk, s);
}
