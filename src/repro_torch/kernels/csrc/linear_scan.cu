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
// only).  Outputs y (BH, T, dv) and h_T (BH, dk, dv), and when asked for
// (the gradient's saved states, csrc/linear_scan_bwd.cu) h_in (BH,
// ceil(T/chunk), dk, dv), the state at the start of each chunk.  chunk, dk,
// dv <= 64.
// T is any length: the last chunk's missing steps read as q = k = v = 0,
// log_w = 0 (decay 1, no input), which is the padding the reference takes,
// and their y is not written.
//
// Form.  The reference's factored chunk form, unchanged: within a chunk of L
// steps, P_t = exp(cumsum log_w), Q~ = Q (*) P (P_{t-1} when strict),
// K~ = K (*) P^-1,
//   A      = mask(Q~ K~^T)               (s <= t; s < t when strict)
//   y      = A V + Q~ h_in  (+ bonus)
//   h_out  = diag(P_L) h_in + (K~ (*) P_L)^T V
// Each exponential is taken once: P^-1 = 1/P (which overflows where the
// reference's exp(-cumsum) does, at a summed |log_w| of ~88.7 per chunk)
// and P_{t-1} is the previous step's P.  P_L multiplies K~ per element
// before the sum, as in the reference, so the kernel is finite exactly
// where the reference is.
//
// Scalar-decay mode (plain convention only): log_w is one value per step
// and batch·head, (BH, T), as Mamba2's decay is a per-head scalar.  Within
// a chunk, with c_t = cumsum log_w (Mamba2's SSD "segsum"),
//   A      = mask(Q K^T) (*) exp(c_t - c_s)     (s <= t)
//   y      = A V + diag(exp(c_t)) Q h_in
//   h_out  = exp(c_L) h_in + (K (*) exp(c_L - c_s))^T V
// For log_w <= 0 every exponent is <= 0, so nothing overflows however
// strong the decay (Mamba2 clamps nothing: at zamba2's init a chunk's
// summed |log_w| reaches ~127, where the factored form is inf).  q and k
// are not scaled; each decay is exp of a difference of two values of c in
// shared memory, taken where A's tile is written and, for the state
// update, once per step.  The mode reads log_w 64x less than the
// broadcast (BH, T, dk) operand.
//
// Bound.  Per chunk and head 2(L^2 dk + L^2 dv + 2 L dk dv) f32 operations
// (half of each L x L product is masked) against 4 (3 dk + 2 dv) L bytes:
// at 64/64/64 the bytes bound the work on the card (see chip_smoke.py's
// count).  A CTA's time goes to the four products and the decay scan.
//
// Design, for 132 SMs:
// - Two CTAs per batch·head, a cluster of two.  Each owns a slab of 32 dv
//   columns of y and of the state.  The dv-independent work is split, not
//   repeated: each CTA loads and scans half the key columns and computes
//   half of A's tiles, and writes them into both CTAs' shared memory
//   (distributed shared memory; two cluster barriers a chunk).  At the
//   serving shape (BH 128) that is 256 CTAs, two on each SM: 108 KB of
//   shared memory each, 128 registers a thread at most.
// - The four products (A = Q~ K~^T, A V, Q~ h_in and (K~ P_L)^T V) run on
//   the tensor cores as mma.sync m16n8k8 in TF32 with the 3xTF32 split: each
//   f32 operand x = hi + lo with hi, lo in TF32, and a b = hi_a hi_b +
//   hi_a lo_b + lo_a hi_b, accumulated in f32.  That keeps near-f32
//   accuracy (plain TF32 would not hold the 2e-4 contract).  A's 20 tiles
//   on or below the diagonal go 10 to a CTA, at most 2 to a warp; in the
//   other products each warp owns 16 rows, and A V stops at the warp's
//   last row.
// - The decay cumsum is a warp-shuffle scan: warp w of a CTA owns 4 of its
//   key columns, each lane two of them at steps a, a+16, a+32, a+48 (a =
//   lane % 16), scanned across the 16 lanes of a step block and carried
//   from block to block.  Each exponential is taken once.
// - The next chunk's q and k arrive by cp.async (16-byte copies of whole
//   rows where the widths allow) into a second buffer while the current
//   chunk computes; its log_w (into A's tile) and its v slab are copied
//   once the current chunk's last reads of A and v are done, behind the
//   state update and the next scan and A.
// - Tiles are row-major, with rows of 68 floats (q, k, A) and 40 floats (v,
//   h), so every fragment load is free of bank conflicts but the
//   transposed read of k~ in the state update (two-way).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMax = 64;              // chunk, dk and dv are at most this
constexpr int kSlab = 32;             // dv columns per CTA
constexpr int kLS = 68;               // row stride of a q, k or A tile
constexpr int kVS = 40;               // row stride of the v and h slabs
constexpr int kThreads = 256;
constexpr int kTile = kMax * kLS;     // a 64 x 64 tile: q~, k~ or A
constexpr int kTileV = kMax * kVS;    // a v slab of one chunk, or the h slab
constexpr int kWarps = kThreads / 32;
constexpr int kHalf = kMax / 2;       // key columns each CTA of a pair scans
// q~ and k~ twice (double buffer), A, v, h, P_L twice, bonus, u, and the
// bonus's partial sums per CTA of the pair and warp
constexpr int kSmemFloats =
    5 * kTile + 2 * kTileV + 4 * kMax + 2 * kWarps * kMax;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);
static_assert(kSmemFloats % 4 == 0, "float4 zeroing");

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// All but the newest copy group have landed.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ---- 3xTF32 tensor-core products
struct FragA {                        // 16 x 8, row-major: hi and lo parts
  unsigned hi[4], lo[4];
};
struct FragB {                        // 8 x 8, column-major
  unsigned hi[2], lo[2];
};

// x = hi + lo: hi is x cut to TF32's 10 mantissa bits (a mask, not a
// conversion: cvt.rna.tf32 issues at a fraction of the rate and bounded the
// products), lo = x - hi exactly; the tensor core reads lo's top 10 bits.
// The error of a product is then ~2^-19 of it, against the 2e-4 contract.
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An f32 accumulator of 3xTF32 products: the hi x hi terms and the two
// cross terms in separate registers, so each chain of dependent mma is
// short; the sum is big + small.
struct Acc {
  float big[4] = {}, small[4] = {};
  __device__ __forceinline__ float get(int e) const { return big[e] + small[e]; }
};

// c += a b in f32 accuracy
__device__ __forceinline__ void mma3(Acc& c, const FragA& a, const FragB& b) {
  mma_tf32(c.small, a.lo, b.hi);
  mma_tf32(c.big, a.hi, b.hi);
  mma_tf32(c.small, a.hi, b.lo);
}

// Lane (g, t) = (lane / 4, lane % 4) of the m16n8k8 fragments.
// A[r][k] = m[(r0 + r) * ld + k0 + k]
__device__ __forceinline__ FragA frag_a(const float* m, int ld, int r0, int k0,
                                        int g, int t) {
  FragA f;
  const float* p = m + (r0 + g) * ld + k0 + t;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8 * ld], f.hi[1], f.lo[1]);
  split(p[4], f.hi[2], f.lo[2]);
  split(p[8 * ld + 4], f.hi[3], f.lo[3]);
  return f;
}

// A[r][k] = m[(k0 + k) * ld + r0 + r] * scale[r]: a transposed read
__device__ __forceinline__ FragA frag_a_t(const float* m, int ld, int r0,
                                          int k0, float s0, float s8, int g,
                                          int t) {
  FragA f;
  const float* p = m + (k0 + t) * ld + r0 + g;
  split(p[0] * s0, f.hi[0], f.lo[0]);
  split(p[8] * s8, f.hi[1], f.lo[1]);
  split(p[4 * ld] * s0, f.hi[2], f.lo[2]);
  split(p[4 * ld + 8] * s8, f.hi[3], f.lo[3]);
  return f;
}

// A[r][k] = m[(k0 + k) * ld + r0 + r] * scale[k0 + k]: a transposed read
// scaled along the depth (the scalar-decay state update)
__device__ __forceinline__ FragA frag_a_tk(const float* m, int ld, int r0,
                                           int k0, const float* scale, int g,
                                           int t) {
  FragA f;
  const float* p = m + (k0 + t) * ld + r0 + g;
  const float s0 = scale[k0 + t], s4 = scale[k0 + t + 4];
  split(p[0] * s0, f.hi[0], f.lo[0]);
  split(p[8] * s0, f.hi[1], f.lo[1]);
  split(p[4 * ld] * s4, f.hi[2], f.lo[2]);
  split(p[4 * ld + 8] * s4, f.hi[3], f.lo[3]);
  return f;
}

// B[k][n] = m[(n0 + n) * ld + k0 + k]: the rows of m are B's columns
__device__ __forceinline__ FragB frag_b_t(const float* m, int ld, int n0,
                                          int k0, int g, int t) {
  FragB f;
  const float* p = m + (n0 + g) * ld + k0 + t;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[4], f.hi[1], f.lo[1]);
  return f;
}

// B[k][n] = m[(k0 + k) * ld + n0 + n]
__device__ __forceinline__ FragB frag_b(const float* m, int ld, int k0, int n0,
                                        int g, int t) {
  FragB f;
  const float* p = m + (k0 + t) * ld + n0 + g;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[4 * ld], f.hi[1], f.lo[1]);
  return f;
}

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* log_w;
  const float* h0;
  const float* u;
  float* y;
  float* h_out;
  float* h_in;                        // chunk-start states, or null
  int t_len, dk, dv, chunk;
  bool vec_qk, vec_lw, vec_v;         // 16-byte copies of q and k, ...
};

// Starts the copies of `rows` rows of `width` floats (row pitch `pitch`)
// into a tile with rows of `stride` floats; rows at or past `n` are zeros.
__device__ __forceinline__ void copy_rows(float* dst, int stride,
                                          const float* src, long long pitch,
                                          int rows, int n, int width,
                                          bool vec, int tid) {
  const int per_row = vec ? width / 4 : width;   // copies per row
  if (kThreads % per_row == 0) {   // each thread keeps its column
    const int c = (tid % per_row) * (vec ? 4 : 1);
    const int step = kThreads / per_row;
    for (int r = tid / per_row; r < rows; r += step) {
      const bool ok = r < n;
      const float* from = src + (ok ? r : 0) * pitch + c;
      if (vec) {
        cp_async16(dst + r * stride + c, from, ok);
      } else {
        cp_async4(dst + r * stride + c, from, ok);
      }
    }
    return;
  }
  for (int e = tid; e < rows * per_row; e += kThreads) {
    const int r = e / per_row, c = (e % per_row) * (vec ? 4 : 1);
    const bool ok = r < n;
    const float* from = src + (ok ? r : 0) * pitch + c;
    if (vec) {
      cp_async16(dst + r * stride + c, from, ok);
    } else {
      cp_async4(dst + r * stride + c, from, ok);
    }
  }
}

// Starts the copies of the chunk at step c0: q and k into sq / sk, key
// columns j_lo .. j_lo + 31 (this CTA's half).  Steps past T are zeros.
__device__ __forceinline__ void load_qk(const Args& a, long long bh, int c0,
                                        int j_lo, float* sq, float* sk,
                                        int tid) {
  const int n = min(a.chunk, a.t_len - c0);
  const int width = min(kHalf, a.dk - j_lo);
  if (width <= 0) return;
  const long long row0 = (bh * a.t_len + c0) * a.dk + j_lo;
  copy_rows(sq + j_lo, kLS, a.q + row0, a.dk, a.chunk, n, width, a.vec_qk,
            tid);
  copy_rows(sk + j_lo, kLS, a.k + row0, a.dk, a.chunk, n, width, a.vec_qk,
            tid);
}

// The same for the chunk's v slab, into sv.
__device__ __forceinline__ void load_v(const Args& a, long long bh, int c0,
                                       int col0, int wv, float* sv, int tid) {
  if (wv <= 0) return;                   // the second CTA when dv <= 32
  const int n = min(a.chunk, a.t_len - c0);
  copy_rows(sv, kVS, a.v + (bh * a.t_len + c0) * a.dv + col0, a.dv, a.chunk,
            n, wv, a.vec_v, tid);
}

// The same for the chunk's log_w, into sl (rows of kLS floats).
__device__ __forceinline__ void load_log_w(const Args& a, long long bh, int c0,
                                           int j_lo, float* sl, int tid) {
  const int n = min(a.chunk, a.t_len - c0);
  const int width = min(kHalf, a.dk - j_lo);
  if (width <= 0) return;
  copy_rows(sl + j_lo, kLS, a.log_w + (bh * a.t_len + c0) * a.dk + j_lo,
            a.dk, a.chunk, n, width, a.vec_lw, tid);
}

// The scalar-decay mode's log_w of the chunk, (BH, T): kMax steps into sl,
// zeros past the chunk's last step.  Each CTA of the pair loads it whole.
__device__ __forceinline__ void load_log_w_scalar(const Args& a, long long bh,
                                                  int c0, float* sl, int tid) {
  if (tid >= kMax) return;
  const bool ok = tid < min(a.chunk, a.t_len - c0);
  cp_async4(sl + tid, a.log_w + bh * a.t_len + c0 + (ok ? tid : 0), ok);
}

template <bool kStrict, bool kScalar>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 2)
linear_scan_kernel(const Args a) {
  static_assert(!(kStrict && kScalar), "the scalar decay is plain only");
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                      // [2][kTile] q, then q~: [t][j]
  float* sk = sq + 2 * kTile;            // [2][kTile] k, then k~: [t][j]
  float* sa = sk + 2 * kTile;            // A: [t][s]; log_w before the scan
  float* sv = sa + kTile;                // v slab: [t][c]
  float* sh = sv + kTileV;               // h slab: [j][c]
  float* pl = sh + kTileV;               // [2][kMax] P_L per key column
  float* sb = pl + 2 * kMax;             // bonus per step
  float* su = sb + kMax;                 // u
  float* bp = su + kMax;                 // [rank][warp][t] partial bonus
  // the scalar-decay mode's own, in the space of the four above: pl holds
  // each chunk's log_w (double buffer), then c_t, exp(c_t), exp(c_L - c_t)
  float* sc = sb;
  float* se = su;
  float* sd = bp;

  // the two CTAs of a batch·head form a cluster: rank r owns state columns
  // 32r.. and scans key columns 32r..; each writes what it shares (q~, k~,
  // P_L, bonus partials, its half of A's tiles) into both shared memories
  cg::cluster_group pair = cg::this_cluster();
  const int rank = static_cast<int>(pair.block_rank());
  auto both = [&](float* local) {
    return pair.map_shared_rank(local, static_cast<unsigned>(rank ^ 1));
  };

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;         // fragment coordinates
  const long long bh = blockIdx.x / 2;
  const int col0 = rank * kSlab;
  const int j_lo = rank * kHalf;
  const int wv = min(kSlab, a.dv - col0);        // may be <= 0 (dv <= 32)
  const bool bonus = kStrict && a.u != nullptr;
  const unsigned full = 0xffffffffu;

  for (int i = tid; i < kSmemFloats / 4; i += kThreads) {
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  pair.sync();                           // both zeroed before any copy or
                                         // write from the other CTA
  for (int e = tid; e < a.dk * kSlab; e += kThreads) {
    const int j = e / kSlab, c = e % kSlab;
    if (c < wv && a.h0 != nullptr) {
      sh[j * kVS + c] = a.h0[(bh * a.dk + j) * a.dv + col0 + c];
    }
  }
  if (bonus && tid < a.dk) su[tid] = a.u[bh * a.dk + tid];

  // the scan's lanes: key columns j0, j0 + 1 (4 per warp) at steps
  // sa_ + 16i
  const int sa_ = lane % 16;
  const int j0 = j_lo + 4 * warp + 2 * (lane / 16);
  // copy groups, in order: q and k of a chunk (during the previous chunk's
  // products), then its log_w (into A's tile, free once A V is done), then
  // its v; a wait for all but the newest group finds the first two landed
  // (the scalar mode's log_w comes with q and k, into pl)
  if (a.t_len > 0) load_qk(a, bh, 0, j_lo, sq, sk, tid);
  if (kScalar && a.t_len > 0) load_log_w_scalar(a, bh, 0, pl, tid);
  cp_async_commit();
  if (!kScalar && a.t_len > 0) load_log_w(a, bh, 0, j_lo, sa, tid);
  cp_async_commit();
  if (a.t_len > 0) load_v(a, bh, 0, col0, wv, sv, tid);
  cp_async_commit();

  // the products: warp w owns rows 16 (w / 2) .. + 15 (of t, or of j in
  // the state update)
  const int m0 = 16 * (warp / 2);
  const int dk8 = (a.dk + 7) & ~7;
  const int chunk8 = (a.chunk + 7) & ~7;
  int buf = 0;
  for (int c0 = 0; c0 < a.t_len; c0 += a.chunk, buf ^= 1) {
    float* sqb = sq + buf * kTile;
    float* skb = sk + buf * kTile;
    float* plb = pl + buf * kMax;
    const int n = min(a.chunk, a.t_len - c0);
    cp_async_wait_prior();               // this chunk's q, k and log_w
    __syncthreads();
    if (a.h_in != nullptr) {             // h_in of the chunk, this CTA's slab
      const long long nch = (a.t_len + a.chunk - 1) / a.chunk;
      float* dst = a.h_in + (bh * nch + c0 / a.chunk) * a.dk * a.dv + col0;
      for (int e = tid; e < a.dk * kSlab; e += kThreads) {
        const int j = e / kSlab, c = e % kSlab;
        if (c < wv) dst[(long long)j * a.dv + c] = sh[j * kVS + c];
      }
    }

    if constexpr (kScalar) {
      // ---- the chunk's decays: warp 0 scans log_w, two steps a lane
      // (zeros past the chunk, so step 63 holds c_L), in each CTA; q and k
      // stay as they are, and this CTA's half of them goes to the other
      if (warp == 0) {
        float x0 = plb[lane], x1 = plb[lane + 32];
#pragma unroll
        for (int off = 1; off < 32; off *= 2) {
          const float y0 = __shfl_up_sync(full, x0, off);
          const float y1 = __shfl_up_sync(full, x1, off);
          if (lane >= off) {
            x0 += y0;
            x1 += y1;
          }
        }
        x1 += __shfl_sync(full, x0, 31);
        const float cl = __shfl_sync(full, x1, 31);
        sc[lane] = x0;
        sc[lane + 32] = x1;
        se[lane] = expf(x0);
        se[lane + 32] = expf(x1);
        sd[lane] = expf(cl - x0);
        sd[lane + 32] = expf(cl - x1);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int at = (sa_ + 16 * i) * kLS + j0;
        *reinterpret_cast<float2*>(both(sqb) + at) =
            *reinterpret_cast<const float2*>(sqb + at);
        *reinterpret_cast<float2*>(both(skb) + at) =
            *reinterpret_cast<const float2*>(skb + at);
      }
    } else {
      // ---- decays of this CTA's key columns: a scan over the steps, q and
      // k scaled in place here and in the other CTA.  Every step of the lane
      // is independent but for the carry, a chain of adds.
      float2 x[4];                       // log_w, then its in-block scan
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = sa_ + 16 * i;
        const float2 l = *reinterpret_cast<const float2*>(sa + t * kLS + j0);
        x[i] = make_float2(t < a.chunk && j0 < a.dk ? l.x : 0.f,
                           t < a.chunk && j0 + 1 < a.dk ? l.y : 0.f);
      }
#pragma unroll
      for (int off = 1; off < 16; off *= 2) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float y0 = __shfl_up_sync(full, x[i].x, off, 16);
          const float y1 = __shfl_up_sync(full, x[i].y, off, 16);
          if (sa_ >= off) {
            x[i].x += y0;
            x[i].y += y1;
          }
        }
      }
      float2 p[4];
      float2 carry = make_float2(0.f, 0.f);  // log P before the block
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float t0 = __shfl_sync(full, x[i].x, 15, 16);
        const float t1 = __shfl_sync(full, x[i].y, 15, 16);
        p[i] = make_float2(expf(carry.x + x[i].x), expf(carry.y + x[i].y));
        carry.x += t0;
        carry.y += t1;
      }
      const float2 uu = bonus ? make_float2(su[j0], su[j0 + 1])
                              : make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = sa_ + 16 * i;
        // P_{t-1}: the previous lane's P, or for the block's first lane the
        // last lane's P of the previous block (1 before the chunk)
        const float2 send = sa_ == 15 && i > 0 ? p[i - 1] : p[i];
        float2 prev =
            make_float2(__shfl_sync(full, send.x, (sa_ + 15) % 16, 16),
                        __shfl_sync(full, send.y, (sa_ + 15) % 16, 16));
        if (sa_ == 0 && i == 0) prev = make_float2(1.f, 1.f);
        float2 qv = *reinterpret_cast<float2*>(sqb + t * kLS + j0);
        float2 kv = *reinterpret_cast<float2*>(skb + t * kLS + j0);
        if (bonus) {                       // from the raw q and k
          float part = qv.x * (uu.x * kv.x) + qv.y * (uu.y * kv.y);
          part += __shfl_xor_sync(full, part, 16);
          if (lane < 16) {
            const int at = (rank * kWarps + warp) * kMax + t;
            bp[at] = part;
            both(bp)[at] = part;
          }
        }
        const bool ok = t < a.chunk;       // P^-1: the correctly rounded 1/P
        qv.x = ok ? qv.x * (kStrict ? prev.x : p[i].x) : 0.f;
        qv.y = ok ? qv.y * (kStrict ? prev.y : p[i].y) : 0.f;
        kv.x = ok ? kv.x * __frcp_rn(p[i].x) : 0.f;
        kv.y = ok ? kv.y * __frcp_rn(p[i].y) : 0.f;
        const int at = t * kLS + j0;
        *reinterpret_cast<float2*>(sqb + at) = qv;
        *reinterpret_cast<float2*>(skb + at) = kv;
        *reinterpret_cast<float2*>(both(sqb) + at) = qv;
        *reinterpret_cast<float2*>(both(skb) + at) = kv;
      }
      // steps past the chunk add log_w = 0, so step 63 holds P_L
      if (sa_ == 15) {
        *reinterpret_cast<float2*>(plb + j0) = p[3];
        *reinterpret_cast<float2*>(both(plb) + j0) = p[3];
      }
    }

    // ---- the next chunk's q and k, while this one computes
    if (c0 + a.chunk < a.t_len) {
      load_qk(a, bh, c0 + a.chunk, j_lo, sq + (buf ^ 1) * kTile,
              sk + (buf ^ 1) * kTile, tid);
      if (kScalar) {
        load_log_w_scalar(a, bh, c0 + a.chunk, pl + (buf ^ 1) * kMax, tid);
      }
    }
    cp_async_commit();
    pair.sync();                         // q~, k~, P_L and the partials of
                                         // both CTAs; every read of log_w

    if (bonus && tid < kMax) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 2 * kWarps; ++w) s += bp[w * kMax + tid];
      sb[tid] = s;
    }

    // ---- A = mask(q~ k~^T).  Its 20 tiles of 16 x 8 on or below the
    // diagonal, 10 per CTA, at most 2 a warp: warp w takes one row block
    // and up to 2 column blocks from a first one on, written here and in
    // the other CTA.  The rest stay zero.
    {
      // per CTA and warp, packed: row block (2 bits), first column block
      // (3 bits), tile count (2 bits).  CTA 0: {3,0,2} {3,2,2} {3,4,2}
      // {3,6,2} {0,0,2}; CTA 1: {2,0,2} {2,2,2} {2,4,2} {1,0,2} {1,2,2}
      const unsigned rows = rank ? 0x16au : 0xffu;
      const unsigned cols = rank ? 0x2110u : 0xd10u;
      const unsigned counts = 0x2aau;
      const int ar = 16 * ((rows >> (2 * warp)) & 3);
      const int ac = (cols >> (3 * warp)) & 7;
      const int count = (counts >> (2 * warp)) & 3;
      if (count > 0 && ar < a.chunk) {
        Acc acc[2];
        bool need[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          need[i] = i < count && 8 * (ac + i) < a.chunk;
        }
#pragma unroll
        for (int k0 = 0; k0 < kMax; k0 += 8) {
          if (k0 >= dk8) break;          // uniform: the loop unrolls whole
          const FragA fq = frag_a(sqb, kLS, ar, k0, g, t4);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (need[i]) {
              mma3(acc[i], fq, frag_b_t(skb, kLS, 8 * (ac + i), k0, g, t4));
            }
          }
        }
        float* sa_other = both(sa);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (need[i]) {
            const int s0 = 8 * (ac + i) + 2 * t4;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int t = ar + g + 8 * h;
              const bool k0_ = kStrict ? s0 < t : s0 <= t;
              const bool k1_ = kStrict ? s0 + 1 < t : s0 + 1 <= t;
              float2 val = make_float2(k0_ ? acc[i].get(2 * h) : 0.f,
                                       k1_ ? acc[i].get(2 * h + 1) : 0.f);
              if constexpr (kScalar) {   // (q_t . k_s) exp(c_t - c_s)
                const float ct = sc[t];
                if (k0_) val.x *= expf(ct - sc[s0]);
                if (k1_) val.y *= expf(ct - sc[s0 + 1]);
              }
              *reinterpret_cast<float2*>(sa + t * kLS + s0) = val;
              *reinterpret_cast<float2*>(sa_other + t * kLS + s0) = val;
            }
          }
        }
      }
    }
    cp_async_wait_prior();               // this chunk's v
    pair.sync();                         // A of both CTAs, the bonus and v

    // ---- y = A V + q~ h_in (+ bonus) and the state update: warp w, rows
    // m0.. (of t for y, of j for h), slab columns 16 (w % 2)..
    const int nc = 16 * (warp % 2);
    bool col[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) col[i] = nc + 8 * i < wv;
    const bool y_rows = m0 < n, h_rows = m0 < a.dk;
    // the state's decay on row j: P_L of key column j, or exp(c_L)
    const float pl0 = kScalar ? se[kMax - 1] : plb[m0 + g];
    const float pl8 = kScalar ? se[kMax - 1] : plb[m0 + g + 8];
    Acc ya[2], ha[2];
    if constexpr (kScalar) {   // exp(c_t) q_t h_in first, then A V onto it
      if (y_rows && (c0 > 0 || a.h0 != nullptr)) {
#pragma unroll
        for (int k0 = 0; k0 < kMax; k0 += 8) {
          if (k0 >= dk8) break;
          const FragA fq = frag_a(sqb, kLS, m0, k0, g, t4);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (col[i]) mma3(ya[i], fq, frag_b(sh, kVS, k0, nc + 8 * i, g, t4));
          }
        }
        const float e0 = se[m0 + g], e8 = se[m0 + g + 8];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ya[i].big[e] *= e < 2 ? e0 : e8;
            ya[i].small[e] *= e < 2 ? e0 : e8;
          }
      }
    }
    const int s_y = min(chunk8, m0 + 16);      // A is zero past the rows
#pragma unroll
    for (int k0 = 0; k0 < kMax; k0 += 8) {
      if (k0 >= chunk8) break;
      FragB fv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (col[i]) fv[i] = frag_b(sv, kVS, k0, nc + 8 * i, g, t4);
      }
      if (y_rows && k0 < s_y) {
        const FragA fa = frag_a(sa, kLS, m0, k0, g, t4);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (col[i]) mma3(ya[i], fa, fv[i]);
        }
      }
      if (h_rows) {        // (k~ (*) P_L)^T V, or (k (*) exp(c_L - c_s))^T V
        const FragA fk = kScalar ? frag_a_tk(skb, kLS, m0, k0, sd, g, t4)
                                 : frag_a_t(skb, kLS, m0, k0, pl0, pl8, g, t4);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (col[i]) mma3(ha[i], fk, fv[i]);
        }
      }
    }
    if (!kScalar && y_rows && (c0 > 0 || a.h0 != nullptr)) {  // + q~ h_in
#pragma unroll
      for (int k0 = 0; k0 < kMax; k0 += 8) {
        if (k0 >= dk8) break;
        const FragA fq = frag_a(sqb, kLS, m0, k0, g, t4);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (col[i]) mma3(ya[i], fq, frag_b(sh, kVS, k0, nc + 8 * i, g, t4));
        }
      }
    }
    float* yb = a.y + (bh * a.t_len + c0) * a.dv + col0;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = m0 + g + 8 * h, c = nc + 8 * i + 2 * t4;
        if (t < n && c < wv) {
          float2 out = make_float2(ya[i].get(2 * h), ya[i].get(2 * h + 1));
          if (bonus) {
            out.x += sb[t] * sv[t * kVS + c];
            out.y += sb[t] * sv[t * kVS + c + 1];
          }
          float* dst = yb + (long long)t * a.dv + c;
          if (a.dv % 2 == 0) {             // c is even: 8-byte aligned
            *reinterpret_cast<float2*>(dst) = out;
          } else {
            dst[0] = out.x;
            if (c + 1 < wv) dst[1] = out.y;
          }
        }
      }
    __syncthreads();                     // every read of v and h_in is done

    if (!kScalar && c0 + a.chunk < a.t_len) {
      load_log_w(a, bh, c0 + a.chunk, j_lo, sa, tid);
    }
    cp_async_commit();
    if (c0 + a.chunk < a.t_len) load_v(a, bh, c0 + a.chunk, col0, wv, sv, tid);
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = m0 + g + 8 * (e / 2), c = nc + 8 * i + 2 * t4 + e % 2;
        if (j < a.dk && c < wv) {
          sh[j * kVS + c] = (e < 2 ? pl0 : pl8) * sh[j * kVS + c] + ha[i].get(e);
        }
      }
  }
  __syncthreads();
  for (int e = tid; e < a.dk * kSlab; e += kThreads) {
    const int j = e / kSlab, c = e % kSlab;
    if (c < wv) a.h_out[(bh * a.dk + j) * a.dv + col0 + c] = sh[j * kVS + c];
  }
  pair.sync();                           // no write from the other CTA is
                                         // left in flight when it exits
}

constexpr int kMaxDevices = 64;

// The shared-memory opt-in, once per device and mode: later launches may be
// inside a CUDA-graph capture, where only stream work belongs.
template <bool kStrict, bool kScalar>
int opt_in() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!done[dev]) {
    err = cudaFuncSetAttribute(linear_scan_kernel<kStrict, kScalar>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(linear_scan_kernel<kStrict, kScalar>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    done[dev] = true;
  }
  return 0;
}

template <bool kStrict, bool kScalar>
int launch(const Args& a, int bh, cudaStream_t stream) {
  const int err = opt_in<kStrict, kScalar>();
  if (err != 0) return err;
  linear_scan_kernel<kStrict, kScalar>
      <<<bh * 2, kThreads, kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStrict, bool kScalar>
int ctas_per_sm() {
  int err = opt_in<kStrict, kScalar>();
  if (err != 0) return -err;
  int dev = 0, sms = 0, clusters = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * sms * 4);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  e = cudaOccupancyMaxActiveClusters(
      &clusters, linear_scan_kernel<kStrict, kScalar>, &cfg);
  return e == cudaSuccess ? 2 * clusters / sms : -static_cast<int>(e);
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// h0, u and h_in may be null; u is read only when strict != 0.  Any T >= 0.
// scalar != 0: log_w is (BH, T), one decay per step and batch·head (the
// plain convention only).
extern "C" int linear_scan_chunked_f32(const float* q, const float* k,
                                       const float* v, const float* log_w,
                                       const float* h0, const float* u,
                                       float* y, float* h_out, float* h_in,
                                       int bh, int t,
                                       int dk, int dv, int chunk, int strict,
                                       int scalar, void* stream) {
  if (chunk < 1 || chunk > kMax || dk < 1 || dk > kMax || dv < 1 ||
      dv > kMax || t < 0 || bh < 0 || (strict && scalar)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bh == 0) return 0;
  auto aligned = [](const float* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  Args a{q, k, v, log_w, h0, u, y, h_out, h_in, t, dk, dv, chunk,
         dk % 4 == 0 && aligned(q) && aligned(k),
         dk % 4 == 0 && aligned(log_w), dv % 4 == 0 && aligned(v)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scalar) return launch<false, true>(a, bh, s);
  return strict ? launch<true, false>(a, bh, s) : launch<false, false>(a, bh, s);
}

// CTAs of the kernel that fit on one SM at once (after the opt-in): the
// clusters of two the device holds at once, as CTAs per SM; or a negative
// cudaError_t.  mode: 0 plain, 1 strict, 2 plain with the scalar decay.
extern "C" int linear_scan_ctas_per_sm(int mode) {
  if (mode == 2) return ctas_per_sm<false, true>();
  return mode == 1 ? ctas_per_sm<true, false>() : ctas_per_sm<false, false>();
}
