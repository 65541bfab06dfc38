// Pose2Pose2 linearize: weighted, whitened residual and both Jacobians of
// every factor of a batch, one thread per factor.
//
// Replaces rome_tpu/ops/linearize_pallas.py:_kernel (the TPU kernel, launched
// by pose2pose2_linearize_planes). Math as in rome_tpu_torch/ops/
// fused_linearize.py, the plain version this kernel is held to:
//   r0 = (R(-q_th)(p_t + R(p_th) z_t - q_t), wrap(p_th + z_th - q_th))
//   J1 = [[c1, -s1, a], [s1, c1, b], [0, 0, 1]]      (c1, s1 of p_th - q_th)
//   J2 = [[-1, 0, r0y], [0, -1, -r0x], [0, 0, -1]]
//   outputs w * S r0, w * S J1, w * S J2
//
// Limits on an H100:
// - It reads 19 values and writes 21 per factor (76 B in, 84 B out in f32),
//   against ~60 flops and two sincos: it is bound by memory bandwidth.
// - At the citygrid size (n = 13,085) it is bound by launch latency: about
//   100 blocks of 128 threads on 132 SMs, a few microseconds of traffic.
// - The TPU kernel's 24-plane (8, 128)-tile packing does not carry over:
//   this kernel reads the port's row-major (n, 3) / (n, 3, 3) layout
//   directly, and each thread masks i < n itself, so no tail of the batch
//   is dropped.
// Accuracy: built without --use_fast_math; sincosf / sincos and fmodf / fmod
// are the full-accuracy device functions.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void sin_cos(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void sin_cos(double x, double* s, double* c) {
  sincos(x, s, c);
}
__device__ __forceinline__ float fmod_t(float x, float y) { return fmodf(x, y); }
__device__ __forceinline__ double fmod_t(double x, double y) { return fmod(x, y); }

// sym_rem: mod(x + pi, 2 pi) - pi with the sign of the divisor (jnp.mod /
// torch.remainder semantics); fmod is exact.
template <typename T>
__device__ __forceinline__ T wrap_angle(T x) {
  const T pi = T(3.141592653589793);
  const T two_pi = T(6.283185307179586);
  T m = fmod_t(x + pi, two_pi);
  if (m < T(0)) m += two_pi;
  return m - pi;
}

template <typename T>
__global__ void pose2pose2_linearize_kernel(
    const T* __restrict__ p, const T* __restrict__ q, const T* __restrict__ z,
    const T* __restrict__ S, const T* __restrict__ w, T* __restrict__ r,
    T* __restrict__ J1, T* __restrict__ J2, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const T px = p[3 * i], py = p[3 * i + 1], pt = p[3 * i + 2];
  const T qx = q[3 * i], qy = q[3 * i + 1], qt = q[3 * i + 2];
  const T zx = z[3 * i], zy = z[3 * i + 1], zt = z[3 * i + 2];

  T sp, cp, sq, cq;
  sin_cos(pt, &sp, &cp);
  sin_cos(qt, &sq, &cq);
  const T c1 = cp * cq + sp * sq;  // cos(pt - qt)
  const T s1 = sp * cq - cp * sq;  // sin(pt - qt)

  const T dx = px + cp * zx - sp * zy - qx;
  const T dy = py + sp * zx + cp * zy - qy;
  const T r0x = cq * dx + sq * dy;
  const T r0y = -sq * dx + cq * dy;
  const T r0t = wrap_angle(pt + zt - qt);

  const T a = -c1 * zy - s1 * zx;
  const T b = -s1 * zy + c1 * zx;

  const T r0[3] = {r0x, r0y, r0t};
  const T A[3][3] = {{c1, -s1, a}, {s1, c1, b}, {T(0), T(0), T(1)}};
  const T B[3][3] = {{T(-1), T(0), r0y}, {T(0), T(-1), -r0x}, {T(0), T(0), T(-1)}};

  const T wi = w[i];
  const T* Si = S + 9 * i;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T s0 = Si[3 * k], s1k = Si[3 * k + 1], s2 = Si[3 * k + 2];
    r[3 * i + k] = wi * (s0 * r0[0] + s1k * r0[1] + s2 * r0[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      J1[9 * i + 3 * k + c] = wi * (s0 * A[0][c] + s1k * A[1][c] + s2 * A[2][c]);
      J2[9 * i + 3 * k + c] = wi * (s0 * B[0][c] + s1k * B[1][c] + s2 * B[2][c]);
    }
  }
}

constexpr int kThreads = 128;

template <typename T>
int launch(const T* p, const T* q, const T* z, const T* S, const T* w, T* r,
           T* J1, T* J2, int n, cudaStream_t stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    pose2pose2_linearize_kernel<T><<<blocks, kThreads, 0, stream>>>(
        p, q, z, S, w, r, J1, J2, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rome_pose2pose2_linearize_f32(
    const float* p, const float* q, const float* z, const float* S,
    const float* w, float* r, float* J1, float* J2, int n, cudaStream_t stream) {
  return launch<float>(p, q, z, S, w, r, J1, J2, n, stream);
}

extern "C" int rome_pose2pose2_linearize_f64(
    const double* p, const double* q, const double* z, const double* S,
    const double* w, double* r, double* J1, double* J2, int n,
    cudaStream_t stream) {
  return launch<double>(p, q, z, S, w, r, J1, J2, n, stream);
}
