// Pose2Pose2 linearize, kernel K1: one kernel body for a tile of factors,
// with two epilogues.
//
// Replaces rome_tpu/ops/linearize_pallas.py:_kernel (the TPU kernel, launched
// by pose2pose2_linearize_planes). Math as in rome_tpu_torch/ops/
// fused_linearize.py, the plain versions this kernel is held to:
//   r0 = (R(-q_th)(p_t + R(p_th) z_t - q_t), wrap(p_th + z_th - q_th))
//   J1 = [[c1, -s1, a], [s1, c1, b], [0, 0, 1]]      (c1, s1 of p_th - q_th)
//   J2 = [[-1, 0, r0y], [0, -1, -r0x], [0, 0, -1]]
//
// Epilogues:
// - lin (the Pallas contract): (p, q, z, S, w) -> (w S r0, w S J1, w S J2),
//   float and double instances.
// - normal (the ndchol LM path, one launch per iteration): from the float64
//   pose table, the (n, 2) int64 slot pairs and the float32 z, S, w it
//   writes the float64 residual r (the steps of the generic route:
//   boxplus(p, 0), p o exp(z) with exp(z) wrapped in float32, log(q^-1 o .),
//   S, w), the float32 J1, J2 of the float32-rounded poses (sincosf, as the
//   float32 lin instance computes them: not float64 math rounded at the end),
//   the four J_k^T J_l blocks in float32 (the JtJ entry values in the
//   symbolic phase's order (0,0), (0,1), (1,0), (1,1), each (n, 3, 3)
//   row-major, written straight into the solver's entry vector) and the two
//   float64 contributions J_k^T r (n, 3). No atomics: every output row
//   belongs to one factor.
//
// Design for the H100:
// - A block owns a tile of kTile = 64 consecutive factors, one thread each:
//   205 blocks at n = 13,085, several resident per SM (about 22 KB of shared
//   memory each).
// - The tile's contiguous inputs come into shared memory by TMA 1-D bulk
//   copies (cp.async.bulk ... mbarrier::complete_tx::bytes) on one
//   mbarrier. In the normal epilogue each thread meanwhile loads its slot
//   pair as one 16-byte load and gathers its two pose rows with read-only
//   loads (the pose table, 240 KB on the 10k-pose city grid, stays in L2).
// - Every output of the tile is one contiguous byte range: it is staged in
//   shared memory and written back by a bulk store (cp.async.bulk.global.
//   shared::cta.bulk_group).
// - Bulk copies take 16-byte-aligned addresses and sizes. A range at any
//   4-byte-aligned address (the Pose2Pose2 block of the entry vector follows
//   the PriorPose2 block's 9 entries, 36 B; a tail tile of any length) is
//   staged at the same address modulo 16: the bulk copy takes the aligned
//   interior, and plain 4-byte copies take the head and tail (at most 12 B
//   each). The tail tile is masked by its factor count, no row dropped.
// Limits: bytes. The normal epilogue moves 356 B per factor (68 in, 288
// out) plus the pose table once, against ~130 float64 and ~300 float32
// operations; the lin epilogue 160 B (float32) or 320 B (float64).
// Accuracy: built without --use_fast_math; sincosf / sincos and fmodf / fmod
// are the full-accuracy device functions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // factors per block = threads per block

__device__ __forceinline__ void sin_cos(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void sin_cos(double x, double* s, double* c) {
  sincos(x, s, c);
}
__device__ __forceinline__ float fmod_t(float x, float y) { return fmodf(x, y); }
__device__ __forceinline__ double fmod_t(double x, double y) { return fmod(x, y); }

// fmod(a, b) for b > 0, as exact as fmod: a itself when |a| < b, a - b when
// b <= a < 2b (exact by Sterbenz's lemma), fmod otherwise. A wrapped angle
// plus pi, or a sum of two, takes the first two branches and skips fmod's
// long reduction (which dominates the float64 residual's latency).
template <typename T>
__device__ __forceinline__ T fmod_pos(T a, T b) {
  if (a > -b && a < b) return a;
  if (a >= b && a < T(2) * b) return a - b;
  return fmod_t(a, b);
}

// sym_rem: mod(x + pi, 2 pi) - pi with the sign of the divisor (jnp.mod /
// torch.remainder semantics); fmod is exact.
template <typename T>
__device__ __forceinline__ T wrap_angle(T x) {
  const T pi = T(3.141592653589793);
  const T two_pi = T(6.283185307179586);
  T m = fmod_pos(x + pi, two_pi);
  if (m < T(0)) m += two_pi;
  return m - pi;
}

// The closed form: weighted, whitened r0, J1, J2 of one factor (row-major).
template <typename T>
__device__ __forceinline__ void linearize(const T p[3], const T q[3], const T z[3],
                                          const T S[9], T w, T r[3], T J1[9], T J2[9]) {
  T sp, cp, sq, cq;
  sin_cos(p[2], &sp, &cp);
  sin_cos(q[2], &sq, &cq);
  const T c1 = cp * cq + sp * sq;  // cos(pt - qt)
  const T s1 = sp * cq - cp * sq;  // sin(pt - qt)

  const T dx = p[0] + cp * z[0] - sp * z[1] - q[0];
  const T dy = p[1] + sp * z[0] + cp * z[1] - q[1];
  const T r0x = cq * dx + sq * dy;
  const T r0y = -sq * dx + cq * dy;
  const T r0t = wrap_angle(p[2] + z[2] - q[2]);

  const T a = -c1 * z[1] - s1 * z[0];
  const T b = -s1 * z[1] + c1 * z[0];

  const T r0[3] = {r0x, r0y, r0t};
  const T A[3][3] = {{c1, -s1, a}, {s1, c1, b}, {T(0), T(0), T(1)}};
  const T B[3][3] = {{T(-1), T(0), r0y}, {T(0), T(-1), -r0x}, {T(0), T(0), T(-1)}};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T s0 = S[3 * k], s1k = S[3 * k + 1], s2 = S[3 * k + 2];
    r[k] = w * (s0 * r0[0] + s1k * r0[1] + s2 * r0[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      J1[3 * k + c] = w * (s0 * A[0][c] + s1k * A[1][c] + s2 * A[2][c]);
      J2[3 * k + c] = w * (s0 * B[0][c] + s1k * B[1][c] + s2 * B[2][c]);
    }
  }
}

// The float64 residual in the steps of the generic route
// (solvers/linearize.batch_residual on the float64 graph): p' = boxplus(p, 0)
// and q' likewise (the angle wrapped), qhat = p' o exp(z) with exp(z)'s angle
// wrapped in float32 (z is float32), then log(q'^-1 o qhat), whitened by S and
// weighted by w (both float32, promoted).
__device__ __forceinline__ void residual_f64(const double p[3], const double q[3],
                                             const float z[3], const float S[9], float w,
                                             double r[3]) {
  const double P = wrap_angle(p[2]), Q = wrap_angle(q[2]);
  const double E = double(wrap_angle(z[2]));
  const double zx = double(z[0]), zy = double(z[1]);
  double sP, cP;
  sin_cos(P, &sP, &cP);
  const double hx = p[0] + (cP * zx - sP * zy);
  const double hy = p[1] + (sP * zx + cP * zy);
  const double ht = wrap_angle(P + E);
  const double th = -Q;  // q'^-1
  double sT, cT;
  sin_cos(th, &sT, &cT);
  const double ix = -(cT * q[0] - sT * q[1]);
  const double iy = -(sT * q[0] + cT * q[1]);
  const double rx = ix + (cT * hx - sT * hy);
  const double ry = iy + (sT * hx + cT * hy);
  const double rt = wrap_angle(wrap_angle(th + ht));
  const double wd = double(w);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    r[k] = (double(S[3 * k]) * rx + double(S[3 * k + 1]) * ry + double(S[3 * k + 2]) * rt) * wd;
}

// ---------------------------------------------------------------------------
// contiguous byte ranges between global and shared memory
// ---------------------------------------------------------------------------

// Shared memory for kBytes of a range plus its shift (< 16) off alignment.
template <size_t kBytes>
struct alignas(16) Region {
  unsigned char b[kBytes + 16];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Global bytes [g, g + bytes) staged at s, with s = g (mod 16). The bulk
// copy takes [lo, hi) (16-byte-aligned ends); plain 4-byte copies take
// [0, lo) and [hi, bytes). A range with no aligned interior is all plain.
struct Span {
  uintptr_t g;
  unsigned char* s;
  uint32_t bytes, lo, hi;
};

__device__ __forceinline__ Span span(const void* g, unsigned char* region, uint32_t bytes) {
  Span sp;
  sp.g = reinterpret_cast<uintptr_t>(g);
  sp.s = region + (sp.g & 15);
  sp.bytes = bytes;
  const uintptr_t a0 = (sp.g + 15) & ~uintptr_t(15);
  const uintptr_t a1 = (sp.g + bytes) & ~uintptr_t(15);
  if (a1 > a0) {
    sp.lo = uint32_t(a0 - sp.g);
    sp.hi = uint32_t(a1 - sp.g);
  } else {
    sp.lo = sp.hi = bytes;
  }
  return sp;
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(const Span& sp, uint64_t* bar) {
  if (sp.hi > sp.lo)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
            "r"(smem_u32(sp.s + sp.lo)),
        "l"(sp.g + sp.lo), "r"(sp.hi - sp.lo), "r"(smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ void plain_load(const Span& sp) {
  const uint32_t* g = reinterpret_cast<const uint32_t*>(sp.g);
  uint32_t* s = reinterpret_cast<uint32_t*>(sp.s);
  for (uint32_t b = 0; b < sp.lo; b += 4) s[b / 4] = __ldg(g + b / 4);
  for (uint32_t b = sp.hi; b < sp.bytes; b += 4) s[b / 4] = __ldg(g + b / 4);
}

__device__ __forceinline__ void store(const Span& sp) {
  if (sp.hi > sp.lo) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(sp.g + sp.lo),
                 "r"(smem_u32(sp.s + sp.lo)), "r"(sp.hi - sp.lo)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  uint32_t* g = reinterpret_cast<uint32_t*>(sp.g);
  const uint32_t* s = reinterpret_cast<const uint32_t*>(sp.s);
  for (uint32_t b = 0; b < sp.lo; b += 4) g[b / 4] = s[b / 4];
  for (uint32_t b = sp.hi; b < sp.bytes; b += 4) g[b / 4] = s[b / 4];
  // the shared source must stay valid until the bulk store has read it
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// epilogues: which ranges a tile loads and stores, what a thread computes
// ---------------------------------------------------------------------------

template <typename T>
struct LinEpilogue {
  struct Args {
    const T *p, *q, *z, *S, *w;
    T *r, *J1, *J2;
    int n;
  };
  struct Smem {
    Region<kTile * 3 * sizeof(T)> p, q, z, r;
    Region<kTile * 9 * sizeof(T)> S, J1, J2;
    Region<kTile * sizeof(T)> w;
    uint64_t bar;
  };
  static constexpr int kIn = 5, kOut = 3;
  struct Own {};

  static __device__ __forceinline__ Span in(const Args& a, Smem& sm, int f0, int nt, int i) {
    const uint32_t e = sizeof(T);
    switch (i) {
      case 0: return span(a.p + 3 * size_t(f0), sm.p.b, 3 * e * nt);
      case 1: return span(a.q + 3 * size_t(f0), sm.q.b, 3 * e * nt);
      case 2: return span(a.z + 3 * size_t(f0), sm.z.b, 3 * e * nt);
      case 3: return span(a.S + 9 * size_t(f0), sm.S.b, 9 * e * nt);
      default: return span(a.w + size_t(f0), sm.w.b, e * nt);
    }
  }
  static __device__ __forceinline__ Span out(const Args& a, Smem& sm, int f0, int nt, int j) {
    const uint32_t e = sizeof(T);
    switch (j) {
      case 0: return span(a.r + 3 * size_t(f0), sm.r.b, 3 * e * nt);
      case 1: return span(a.J1 + 9 * size_t(f0), sm.J1.b, 9 * e * nt);
      default: return span(a.J2 + 9 * size_t(f0), sm.J2.b, 9 * e * nt);
    }
  }
  static __device__ __forceinline__ void load_own(const Args&, int, Own&) {}

  static __device__ __forceinline__ void compute(const Args& a, Smem& sm, int f0, int nt, int t,
                                                 const Own&) {
    const T* ps = reinterpret_cast<const T*>(in(a, sm, f0, nt, 0).s) + 3 * t;
    const T* qs = reinterpret_cast<const T*>(in(a, sm, f0, nt, 1).s) + 3 * t;
    const T* zs = reinterpret_cast<const T*>(in(a, sm, f0, nt, 2).s) + 3 * t;
    const T* Ss = reinterpret_cast<const T*>(in(a, sm, f0, nt, 3).s) + 9 * t;
    const T w = reinterpret_cast<const T*>(in(a, sm, f0, nt, 4).s)[t];
    T p[3], q[3], z[3], S[9], r[3], J1[9], J2[9];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p[k] = ps[k];
      q[k] = qs[k];
      z[k] = zs[k];
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) S[k] = Ss[k];
    linearize(p, q, z, S, w, r, J1, J2);
    T* rs = reinterpret_cast<T*>(out(a, sm, f0, nt, 0).s) + 3 * t;
    T* J1s = reinterpret_cast<T*>(out(a, sm, f0, nt, 1).s) + 9 * t;
    T* J2s = reinterpret_cast<T*>(out(a, sm, f0, nt, 2).s) + 9 * t;
#pragma unroll
    for (int k = 0; k < 3; ++k) rs[k] = r[k];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      J1s[k] = J1[k];
      J2s[k] = J2[k];
    }
  }
};

struct NormalEpilogue {
  struct Args {
    const double* values;      // (count, 3) pose table
    const long long* vslots;   // (n, 2) slots of p and q in the table
    const float *z, *S, *w;    // (n, 3), (n, 3, 3), (n,)
    double* r;                 // (n, 3)
    float *J1, *J2;            // (n, 3, 3) each
    float* entries;            // 4 blocks (n, 3, 3): J1'J1, J1'J2, J2'J1, J2'J2
    double* jtr;               // 2 blocks (n, 3): J1'r, J2'r
    int n;
  };
  struct Smem {
    Region<kTile * 12> z;
    Region<kTile * 36> S;
    Region<kTile * 4> w;
    Region<kTile * 24> r, g0, g1;
    Region<kTile * 36> J1, J2, e0, e1, e2, e3;
    uint64_t bar;
  };
  static constexpr int kIn = 3, kOut = 9;
  struct Own {
    double p[3], q[3];
  };

  static __device__ __forceinline__ Span in(const Args& a, Smem& sm, int f0, int nt, int i) {
    switch (i) {
      case 0: return span(a.z + 3 * size_t(f0), sm.z.b, 12u * nt);
      case 1: return span(a.S + 9 * size_t(f0), sm.S.b, 36u * nt);
      default: return span(a.w + size_t(f0), sm.w.b, 4u * nt);
    }
  }
  static __device__ __forceinline__ Span out(const Args& a, Smem& sm, int f0, int nt, int j) {
    const size_t n = size_t(a.n), f = size_t(f0);
    switch (j) {
      case 0: return span(a.r + 3 * f, sm.r.b, 24u * nt);
      case 1: return span(a.J1 + 9 * f, sm.J1.b, 36u * nt);
      case 2: return span(a.J2 + 9 * f, sm.J2.b, 36u * nt);
      case 3: return span(a.entries + 9 * f, sm.e0.b, 36u * nt);
      case 4: return span(a.entries + 9 * (n + f), sm.e1.b, 36u * nt);
      case 5: return span(a.entries + 9 * (2 * n + f), sm.e2.b, 36u * nt);
      case 6: return span(a.entries + 9 * (3 * n + f), sm.e3.b, 36u * nt);
      case 7: return span(a.jtr + 3 * f, sm.g0.b, 24u * nt);
      default: return span(a.jtr + 3 * (n + f), sm.g1.b, 24u * nt);
    }
  }

  // the slot pair as one 16-byte load, then the two pose rows
  static __device__ __forceinline__ void load_own(const Args& a, int i, Own& o) {
    const longlong2 s = __ldg(reinterpret_cast<const longlong2*>(a.vslots) + i);
    const double* P = a.values + 3 * size_t(s.x);
    const double* Q = a.values + 3 * size_t(s.y);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o.p[k] = __ldg(P + k);
      o.q[k] = __ldg(Q + k);
    }
  }

  static __device__ __forceinline__ void compute(const Args& a, Smem& sm, int f0, int nt, int t,
                                                 const Own& o) {
    const float* zs = reinterpret_cast<const float*>(in(a, sm, f0, nt, 0).s) + 3 * t;
    const float* Ss = reinterpret_cast<const float*>(in(a, sm, f0, nt, 1).s) + 9 * t;
    const float w = reinterpret_cast<const float*>(in(a, sm, f0, nt, 2).s)[t];
    float z[3], S[9];
#pragma unroll
    for (int k = 0; k < 3; ++k) z[k] = zs[k];
#pragma unroll
    for (int k = 0; k < 9; ++k) S[k] = Ss[k];

    double r[3];
    residual_f64(o.p, o.q, z, S, w, r);
    float p32[3], q32[3], r32[3], J[2][9];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p32[k] = __double2float_rn(o.p[k]);
      q32[k] = __double2float_rn(o.q[k]);
    }
    linearize(p32, q32, z, S, w, r32, J[0], J[1]);

    double* rs = reinterpret_cast<double*>(out(a, sm, f0, nt, 0).s) + 3 * t;
#pragma unroll
    for (int k = 0; k < 3; ++k) rs[k] = r[k];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      float* Js = reinterpret_cast<float*>(out(a, sm, f0, nt, 1 + s).s) + 9 * t;
#pragma unroll
      for (int k = 0; k < 9; ++k) Js[k] = J[s][k];
    }
    // J_k' J_l, (j, m) = sum_i J_k[i][j] J_l[i][m]
#pragma unroll
    for (int kl = 0; kl < 4; ++kl) {
      const float* A = J[kl >> 1];
      const float* B = J[kl & 1];
      float* Es = reinterpret_cast<float*>(out(a, sm, f0, nt, 3 + kl).s) + 9 * t;
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int m = 0; m < 3; ++m)
          Es[3 * j + m] = A[j] * B[m] + A[3 + j] * B[3 + m] + A[6 + j] * B[6 + m];
    }
    // J_k' r in float64, (j) = sum_i J_k[i][j] r[i]
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      double* gs = reinterpret_cast<double*>(out(a, sm, f0, nt, 7 + s).s) + 3 * t;
#pragma unroll
      for (int j = 0; j < 3; ++j)
        gs[j] = double(J[s][j]) * r[0] + double(J[s][3 + j]) * r[1] + double(J[s][6 + j]) * r[2];
    }
  }
};

// The kernel body: stage the tile's inputs (bulk copies on one mbarrier,
// plain head/tail words, each thread's own loads meanwhile), compute one
// factor per thread into the staged outputs, then store every output range.
template <class E>
__global__ void __launch_bounds__(kTile) pose2pose2_kernel(const typename E::Args a) {
  __shared__ typename E::Smem sm;
  const int t = threadIdx.x;
  const int f0 = blockIdx.x * kTile;
  const int nt = min(kTile, a.n - f0);
  if (t == 0) bar_init(&sm.bar);
  __syncthreads();
  if (t == 0) {
    uint32_t tx = 0;
#pragma unroll
    for (int i = 0; i < E::kIn; ++i) {
      const Span sp = E::in(a, sm, f0, nt, i);
      tx += sp.hi - sp.lo;
    }
    bar_arrive_expect_tx(&sm.bar, tx);
#pragma unroll
    for (int i = 0; i < E::kIn; ++i) bulk_load(E::in(a, sm, f0, nt, i), &sm.bar);
  } else if (t <= E::kIn) {
    plain_load(E::in(a, sm, f0, nt, t - 1));
  }
  typename E::Own own;
  if (t < nt) E::load_own(a, f0 + t, own);
  bar_wait(&sm.bar, 0);
  __syncthreads();
  if (t < nt) E::compute(a, sm, f0, nt, t, own);
  // make this thread's shared-memory writes visible to the bulk stores
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (t < E::kOut) store(E::out(a, sm, f0, nt, t));
}

template <class E>
int launch(const typename E::Args& a, cudaStream_t stream) {
  if (a.n > 0) {
    const int blocks = (a.n + kTile - 1) / kTile;
    pose2pose2_kernel<E><<<blocks, kTile, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rome_pose2pose2_linearize_f32(
    const float* p, const float* q, const float* z, const float* S,
    const float* w, float* r, float* J1, float* J2, int n, cudaStream_t stream) {
  return launch<LinEpilogue<float>>({p, q, z, S, w, r, J1, J2, n}, stream);
}

extern "C" int rome_pose2pose2_linearize_f64(
    const double* p, const double* q, const double* z, const double* S,
    const double* w, double* r, double* J1, double* J2, int n,
    cudaStream_t stream) {
  return launch<LinEpilogue<double>>({p, q, z, S, w, r, J1, J2, n}, stream);
}

extern "C" int rome_pose2pose2_normal_f32(
    const double* values, const long long* vslots, const float* z, const float* S,
    const float* w, double* r, float* J1, float* J2, float* entries, double* jtr, int n,
    cudaStream_t stream) {
  return launch<NormalEpilogue>({values, vslots, z, S, w, r, J1, J2, entries, jtr, n}, stream);
}
