// The gradient of the chunked gated linear scan (csrc/linear_scan.cu) for
// Hopper: dq, dk, dv, d log_w, dh0 and du from dy and dh_T.
//
// The JAX package has no kernel for this: it differentiates its jnp chunked
// scan.  Per batch·head, in the forward's chunk form (linear_scan.cu's
// header; L steps a chunk, P_t = exp(cumsum log_w), Q~ = Q (*) P (P_{t-1}
// when strict), K~ = K (*) P^-1, A = mask(Q~ K~^T)), a chunk's terms are
//   dV     = A^T dY + (K~ (*) P_L) dh_out          (+ b_t dy_t, the bonus)
//   dA     = mask(dY V^T)
//   dQ~    = dA K~ + dY h_in^T,          dq = dQ~ (*) P   (P_{t-1} strict)
//   dK~    = dA^T Q~ + P_L (*) (V dh_out^T), dk = dK~ (*) P^-1
//   dh_in  = Q~^T dY + diag(P_L) dh_out
// and the decay's gradient is a reverse cumulative sum inside each chunk:
// d log_w_t = sum_c h_out (*) dh_out + sum_{s >= t} (q_s (*) dq_s - k_s (*)
// dk_s) over the chunk's steps s, where h_out is the chunk's end state (the
// next chunk's saved start state, or h_T), q (*) dq = Q~ (*) dQ~ and
// k (*) dk = K~ (*) dK~; strict, q_s (*) dq_s counts toward step s - 1 (Q~
// reads P_{s-1}).  (The sum over every later step of the sequence is the
// same number, but its terms grow with the sequence and cancel: in float32
// it lost ~30x the accuracy at 4,096 steps.)  dq and dk there leave out the
// bonus's terms, which do not depend on the decay.  The bonus (strict, u given), with
// g_t = dy_t . v_t and b_t = q_t . (u (*) k_t):
//   du = sum_t g_t q_t (*) k_t,  dq_t += g_t u (*) k_t,  dk_t += g_t u (*) q_t,
//   dv_t += b_t dy_t.
// Scalar-decay mode (log_w (BH, T)): Q~ = Q, K~ = K and the segsum factors
// of the forward, each exponent <= 0 for log_w <= 0:
//   A = mask(Q K^T) (*) exp(c_t - c_s),  dA likewise scaled,
//   dQ = dA K + diag(exp(c_t)) dY h_in^T,  dK = dA^T Q + diag(exp(c_L - c_t))
//   V dh_out^T,  dV = A^T dY + diag(exp(c_L - c_t)) K dh_out,
//   dh_in = Q^T diag(exp(c_t)) dY + exp(c_L) dh_out,
// and d log_w_t the same cumulative sum, summed over the key columns.
//
// Operands (f32, contiguous): q, k, log_w (BH, T, dk) or log_w (BH, T);
// v, dy (BH, T, dv); u (BH, dk) or null; h_in (BH, ceil(T/chunk), dk, dv),
// the chunk-start states the forward saves; h_T, dh_T (BH, dk, dv) or null
// (no gradient into h_T).  Outputs dq, dk (BH, T, dk), dv (BH, T, dv),
// d log_w in log_w's shape, dh0 (BH, dk, dv) or null, du (BH, dk) or null.
// A ragged last chunk reads its missing steps as zeros (the forward's
// padding) and writes no gradient for them.
//
// Design: a first version that is right, not fast.  One CTA of 256 threads
// per batch·head walks the chunks in reverse with dh in shared memory; every
// product is an f32 FMA loop over 64 x 64 tiles with rows of 65 floats
// (each warp reads one row of the left operand, broadcast, and 32 entries of
// the right one in distinct banks).  ~170 KB of shared memory: one CTA an SM.
#include <cuda_runtime.h>

namespace {

constexpr int kMax = 64;              // chunk, dk and dv are at most this
constexpr int kS = 65;                // row stride of every tile
constexpr int kTile = kMax * kS;
constexpr int kThreads = 256;
constexpr int kPer = kMax * kMax / kThreads;   // tile entries a thread
// q~, k~, v, dy, P (or unused), A then dA, h_in, dh, q (*) dq, k (*) dk
constexpr int kTiles = 10;
// P_L, c, exp(c), exp(c_L - c), b, g, u, the chunk's h_out (*) dh_out,
// du partials (4)
constexpr int kVecs = 12;
constexpr int kSmemFloats = kTiles * kTile + kVecs * kMax;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* log_w;
  const float* u;
  const float* h_in;
  const float* h_t;
  const float* dy;
  const float* dh_t;
  float* dq;
  float* dk;
  float* dv;
  float* dlw;
  float* dh0;
  float* du;
  int t_len, dk_, dv_, chunk;
};

template <bool kStrict, bool kScalar>
__global__ void __launch_bounds__(kThreads, 1)
linear_scan_bwd_kernel(const Args a) {
  static_assert(!(kStrict && kScalar), "the scalar decay is plain only");
  extern __shared__ __align__(16) float smem[];
  float* sqt = smem;                  // [t][j] q, then q~
  float* skt = sqt + kTile;           // [t][j] k, then k~
  float* sv = skt + kTile;            // [t][c]
  float* sdy = sv + kTile;            // [t][c]
  float* sp = sdy + kTile;            // [t][j] log_w, then P (per-key mode)
  float* sa = sp + kTile;             // [t][s] A, then dA
  float* sh = sa + kTile;             // [j][c] h_in
  float* sdh = sh + kTile;            // [j][c] dh (of the chunk's end state)
  float* sdq = sdh + kTile;           // [t][j] q (*) dq, bonus left out
  float* sdk = sdq + kTile;           // [t][j] k (*) dk, bonus left out
  float* pl = sdk + kTile;            // P_L per key column; [0] exp(c_L)
  float* sc = pl + kMax;              // c_t (scalar mode)
  float* se = sc + kMax;              // exp(c_t)
  float* sd = se + kMax;              // exp(c_L - c_t)
  float* sb = sd + kMax;              // b_t, the bonus; row sums (scalar)
  float* sg = sb + kMax;              // g_t = dy_t . v_t
  float* su = sg + kMax;              // u
  float* carry = su + kMax;           // sum_c h_out (*) dh_out per key
  float* dup = carry + kMax;          // [4][kMax] du partials

  const int tid = threadIdx.x;
  const long long bh = blockIdx.x;
  const int T = a.t_len, DK = a.dk_, DV = a.dv_, L = a.chunk;
  const int nch = (T + L - 1) / L;
  const bool bonus = kStrict && a.u != nullptr;
  const int jt = tid & (kMax - 1);    // the thread's column in (t, j) loops

  // dh_T (zeros without one) and the last chunk's h_T (*) dh_T term
  for (int e = tid; e < kMax * kMax; e += kThreads) {
    const int j = e / kMax, c = e % kMax;
    sdh[j * kS + c] = (a.dh_t != nullptr && j < DK && c < DV)
                          ? a.dh_t[(bh * DK + j) * DV + c]
                          : 0.f;
  }
  if (tid < kMax) {
    float s = 0.f;
    if (a.dh_t != nullptr && tid < DK) {
      const long long row = (bh * DK + tid) * DV;
      for (int c = 0; c < DV; ++c) s += a.h_t[row + c] * a.dh_t[row + c];
    }
    carry[tid] = s;
    su[tid] = bonus && tid < DK ? a.u[bh * DK + tid] : 0.f;
  }
  __syncthreads();
  if (kScalar && tid == 0) {          // one decay: the sum over the columns
    float s = 0.f;
    for (int j = 0; j < DK; ++j) s += carry[j];
    carry[0] = s;
  }
  float du_acc = 0.f;

  for (int ci = nch - 1; ci >= 0; --ci) {
    const int c0 = ci * L;
    const int n = min(L, T - c0);
    if (ci < nch - 1) {
      // the chunk's end state is the next chunk's start state, still in sh,
      // and dh its cotangent: four threads a key column
      const int j = tid >> 2, part = tid & 3;
      float s = 0.f;
      if (j < DK) {
        for (int c = part; c < DV; c += 4) s += sh[j * kS + c] * sdh[j * kS + c];
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (part == 0) carry[j] = s;
      __syncthreads();
      if (kScalar && tid == 0) {
        float t = 0.f;
        for (int k = 0; k < DK; ++k) t += carry[k];
        carry[0] = t;
      }
    }
    // ---- the chunk's tiles; zeros past its steps and widths
    for (int e = tid; e < kMax * kMax; e += kThreads) {
      const int t = e / kMax, x = e % kMax;
      const bool row = t < n;
      const long long qi = (bh * T + c0 + t) * DK + x;
      const long long vi = (bh * T + c0 + t) * DV + x;
      const bool okk = row && x < DK, okv = row && x < DV;
      sqt[t * kS + x] = okk ? a.q[qi] : 0.f;
      skt[t * kS + x] = okk ? a.k[qi] : 0.f;
      if (!kScalar) sp[t * kS + x] = okk ? a.log_w[qi] : 0.f;
      sv[t * kS + x] = okv ? a.v[vi] : 0.f;
      sdy[t * kS + x] = okv ? a.dy[vi] : 0.f;
      sh[t * kS + x] = (t < DK && x < DV)
                           ? a.h_in[((bh * nch + ci) * DK + t) * DV + x]
                           : 0.f;
    }
    if (kScalar && tid < kMax) {
      sc[tid] = tid < n ? a.log_w[bh * T + c0 + tid] : 0.f;
    }
    __syncthreads();

    // ---- decays, the bonus and g
    if (kScalar) {
      if (tid == 0) {
        float c = 0.f;
        for (int t = 0; t < L; ++t) {
          c += sc[t];
          sc[t] = c;
        }
      }
    } else if (tid < DK) {
      float c = 0.f;
      for (int t = 0; t < L; ++t) {
        c += sp[t * kS + tid];
        sp[t * kS + tid] = expf(c);
      }
      pl[tid] = sp[(L - 1) * kS + tid];
    } else if (tid >= 128 && tid - 128 < L) {   // b_t and g_t, raw q and k
      const int t = tid - 128;
      float b = 0.f, g = 0.f;
      if (bonus) {
        for (int j = 0; j < DK; ++j) {
          b += sqt[t * kS + j] * (su[j] * skt[t * kS + j]);
        }
      }
      for (int c = 0; c < DV; ++c) g += sdy[t * kS + c] * sv[t * kS + c];
      sb[t] = b;
      sg[t] = g;
    }
    __syncthreads();
    if (kScalar) {
      if (tid < L) {
        const float cl = sc[L - 1];
        se[tid] = expf(sc[tid]);
        sd[tid] = expf(cl - sc[tid]);
        if (tid == 0) pl[0] = expf(cl);
      }
    } else {
      // q~ and k~ in place, as the forward scales them
      for (int e = tid; e < kMax * kMax; e += kThreads) {
        const int t = e / kMax, j = e % kMax;
        if (t < L && j < DK) {
          const float p = sp[t * kS + j];
          const float pq = kStrict ? (t > 0 ? sp[(t - 1) * kS + j] : 1.f) : p;
          sqt[t * kS + j] *= pq;
          skt[t * kS + j] *= __frcp_rn(p);
        }
      }
    }
    __syncthreads();

    // ---- A = mask(q~ k~^T) (scalar: (q k^T) (*) exp(c_t - c_s))
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + kThreads * i, t = e / kMax, s = e % kMax;
      float val = 0.f;
      if (t < L && (kStrict ? s < t : s <= t)) {
        for (int j = 0; j < DK; ++j) val += sqt[t * kS + j] * skt[s * kS + j];
        if (kScalar) val *= expf(sc[t] - sc[s]);
      }
      sa[t * kS + s] = val;
    }
    __syncthreads();

    // ---- dv = A^T dY + (k~ (*) P_L) dh (+ b_t dy_t)
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + kThreads * i, t = e / kMax, c = e % kMax;
      if (t >= n || c >= DV) continue;
      float acc = 0.f, acc2 = 0.f;
      for (int s = t; s < L; ++s) acc += sa[s * kS + t] * sdy[s * kS + c];
      if (kScalar) {
        for (int j = 0; j < DK; ++j) acc2 += skt[t * kS + j] * sdh[j * kS + c];
        acc2 *= sd[t];
      } else {
        for (int j = 0; j < DK; ++j) {
          acc2 += (skt[t * kS + j] * pl[j]) * sdh[j * kS + c];
        }
      }
      float out = acc + acc2;
      if (bonus) out += sb[t] * sdy[t * kS + c];
      a.dv[(bh * T + c0 + t) * DV + c] = out;
    }
    __syncthreads();                    // every read of A is done

    // ---- dA = mask(dY V^T) (scalar: (*) exp(c_t - c_s))
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + kThreads * i, t = e / kMax, s = e % kMax;
      float val = 0.f;
      if (t < L && (kStrict ? s < t : s <= t)) {
        for (int c = 0; c < DV; ++c) val += sdy[t * kS + c] * sv[s * kS + c];
        if (kScalar) val *= expf(sc[t] - sc[s]);
      }
      sa[t * kS + s] = val;
    }
    __syncthreads();

    // ---- dq~ = dA k~ + dY h_in^T, dk~ = dA^T q~ + P_L (*) (V dh^T); the
    // thread's column j is the same in every entry, so it sums du's part
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + kThreads * i, t = e / kMax, j = e % kMax;
      if (t >= L || j >= DK) continue;
      float aq = 0.f, hq = 0.f, ak = 0.f, hk = 0.f;
      for (int s = 0; s <= t; ++s) aq += sa[t * kS + s] * skt[s * kS + j];
      for (int c = 0; c < DV; ++c) hq += sdy[t * kS + c] * sh[j * kS + c];
      for (int s = t; s < L; ++s) ak += sa[s * kS + t] * sqt[s * kS + j];
      for (int c = 0; c < DV; ++c) hk += sv[t * kS + c] * sdh[j * kS + c];
      const float dqt = aq + (kScalar ? se[t] * hq : hq);
      const float dkt = ak + (kScalar ? sd[t] * hk : pl[j] * hk);
      sdq[t * kS + j] = sqt[t * kS + j] * dqt;
      sdk[t * kS + j] = skt[t * kS + j] * dkt;
      if (t >= n) continue;
      float gq = dqt, gk = dkt;
      if (!kScalar) {
        const float p = sp[t * kS + j];
        gq *= kStrict ? (t > 0 ? sp[(t - 1) * kS + j] : 1.f) : p;
        gk *= __frcp_rn(p);
      }
      const long long qi = (bh * T + c0 + t) * DK + j;
      if (bonus) {
        const float qr = a.q[qi], kr = a.k[qi], g = sg[t];
        gq += g * (su[j] * kr);
        gk += g * (su[j] * qr);
        du_acc += g * (qr * kr);
      }
      a.dq[qi] = gq;
      a.dk[qi] = gk;
    }

    // ---- dh_in = q~^T dY + diag(P_L) dh  (scalar: q^T diag(e^c) dY +
    // e^{c_L} dh), into registers until every read of dh is done
    float nd[kPer];
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + kThreads * i, j = e / kMax, c = e % kMax;
      nd[i] = 0.f;
      if (j >= DK || c >= DV) continue;
      float acc = 0.f;
      if (kScalar) {
        for (int t = 0; t < L; ++t) {
          acc += (sqt[t * kS + j] * se[t]) * sdy[t * kS + c];
        }
      } else {
        for (int t = 0; t < L; ++t) acc += sqt[t * kS + j] * sdy[t * kS + c];
      }
      nd[i] = acc + (kScalar ? pl[0] : pl[j]) * sdh[j * kS + c];
    }
    __syncthreads();                    // every read of dh, dq~ and dk~ parts
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + kThreads * i, j = e / kMax, c = e % kMax;
      sdh[j * kS + c] = nd[i];
    }

    // ---- d log_w: the reverse cumulative sum, carried across chunks
    if (kScalar) {
      if (tid < L) {
        float r = 0.f;
        for (int j = 0; j < DK; ++j) r += sdq[tid * kS + j] - sdk[tid * kS + j];
        sb[tid] = r;
      }
      __syncthreads();
      if (tid == 0) {
        float run = carry[0];
        for (int t = L - 1; t >= 0; --t) {
          run += sb[t];
          if (t < n) a.dlw[bh * T + c0 + t] = run;
        }
      }
    } else if (tid < DK) {
      float run = carry[tid];
      for (int t = L - 1; t >= 0; --t) {
        if (kStrict) {
          run -= sdk[t * kS + tid];
          if (t < n) a.dlw[(bh * T + c0 + t) * DK + tid] = run;
          run += sdq[t * kS + tid];
        } else {
          run += sdq[t * kS + tid] - sdk[t * kS + tid];
          if (t < n) a.dlw[(bh * T + c0 + t) * DK + tid] = run;
        }
      }
    }
    __syncthreads();
  }

  if (a.dh0 != nullptr) {
    for (int e = tid; e < DK * DV; e += kThreads) {
      const int j = e / DV, c = e % DV;
      a.dh0[(bh * DK + j) * DV + c] = sdh[j * kS + c];
    }
  }
  if (bonus && a.du != nullptr) {
    dup[(tid / kMax) * kMax + jt] = du_acc;
    __syncthreads();
    if (tid < DK) {
      a.du[bh * DK + tid] =
          dup[tid] + dup[kMax + tid] + dup[2 * kMax + tid] + dup[3 * kMax + tid];
    }
  }
}

constexpr int kMaxDevices = 64;

// The shared-memory opt-in, once per device and mode.
template <bool kStrict, bool kScalar>
int opt_in() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!done[dev]) {
    err = cudaFuncSetAttribute(linear_scan_bwd_kernel<kStrict, kScalar>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    done[dev] = true;
  }
  return 0;
}

template <bool kStrict, bool kScalar>
int launch(const Args& a, int bh, cudaStream_t stream) {
  const int err = opt_in<kStrict, kScalar>();
  if (err != 0) return err;
  linear_scan_bwd_kernel<kStrict, kScalar>
      <<<bh, kThreads, kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// u, h_T / dh_T (both or neither), dh0 and du may be null; du is written
// only when strict and u is given.  scalar != 0: log_w and dlog_w are
// (BH, T).
extern "C" int linear_scan_bwd_f32(const float* q, const float* k,
                                   const float* v, const float* log_w,
                                   const float* u, const float* h_in,
                                   const float* h_t, const float* dy,
                                   const float* dh_t, float* dq, float* dk,
                                   float* dv, float* dlw, float* dh0,
                                   float* du, int bh, int t, int dk_dim,
                                   int dv_dim, int chunk, int strict,
                                   int scalar, void* stream) {
  if (chunk < 1 || chunk > kMax || dk_dim < 1 || dk_dim > kMax ||
      dv_dim < 1 || dv_dim > kMax || t < 0 || bh < 0 || (strict && scalar) ||
      ((h_t == nullptr) != (dh_t == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bh == 0 || t == 0) return 0;
  Args a{q, k, v, log_w, u, h_in, h_t, dy, dh_t, dq, dk, dv, dlw, dh0, du,
         t, dk_dim, dv_dim, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scalar) return launch<false, true>(a, bh, s);
  return strict ? launch<true, false>(a, bh, s) : launch<false, false>(a, bh, s);
}
