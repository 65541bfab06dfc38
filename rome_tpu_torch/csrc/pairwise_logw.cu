// Gibbs pairwise scores of the nonparametric belief product (K2, K3):
//
//   logw[v, n, j] = -0.5 * sum_d iv[v, d] * (local(ref[v, n], pts[v, j])_d - mu[v, n, d])^2
//
// for every variable v of a type, output particle n and candidate kernel j.
//
// Replaces the JAX package's Pallas kernels in rome_tpu/ops/pairwise.py:
// - K2 se2_pairwise_logw_kernel <- _se2_kernel (launched by
//   se2_pairwise_logw): SE(2) hybrid local
//     (R(-th_r)(t_p - t_r), wrap(th_p - th_r));
// - K3 euclid_pairwise_logw_kernel <- _euclid_kernel (launched by
//   euclid_pairwise_logw): per-dim difference, wrapped onto [-pi, pi) where
//   circ[d] is 1, for dof <= 8.
// The plain versions they are held to are in rome_tpu_torch/ops/pairwise.py.
// Under jax.vmap the TPU kernels ran once per variable; here the variable
// batch V is a grid dimension, so one launch serves every variable of a type.
//
// What bounds it on an H100: a few tens of flops and one 4-byte store per
// output, against 3*dof loads per row and per column that the block shares.
// So it is bound by the (V, N, Nj) float32 store (at beehive-100, V = 101,
// N = Nj = 100: 4 MB, about a microsecond of HBM time), and at that size by
// the launch. The TPU kernel's point, to keep the (N, Nj, dof) tangent
// intermediate out of device memory, carries over: it lives in registers.
//
// Design:
// - grid (ceil(Nj / 128), ceil(N / 8), V); 128 threads along Nj, each thread
//   owns one column j (its candidate point in registers) and walks the
//   block's 8 rows n. Stores are coalesced along Nj.
// - the block stages its rows of ref and mu in shared memory, and K2 takes
//   cos/sin of th_r there, once per row and not per pair.
// - the ragged N and Nj edges are masked here; nothing is padded to the
//   TPU's (8, 128) tiles.
// Accuracy: built without --use_fast_math. The wrap is
// x - 2pi * floorf((x + pi) / (2pi)) with an IEEE division, as the Pallas
// kernel computes it, so an angle near +-pi wraps to the same side.

#include <cuda_runtime.h>

namespace {

constexpr int kThreadsJ = 128;
constexpr int kRowsN = 8;
constexpr int kMaxDof = 8;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ float floor_turns(float x) {
  return floorf(__fdiv_rn(x + kPi, kTwoPi));
}

__global__ void se2_pairwise_logw_kernel(
    const float* __restrict__ ref, const float* __restrict__ mu,
    const float* __restrict__ pts, const float* __restrict__ inv_var,
    float* __restrict__ out, int N, int Nj) {
  __shared__ float s_x[kRowsN], s_y[kRowsN], s_th[kRowsN], s_c[kRowsN],
      s_s[kRowsN], s_mx[kRowsN], s_my[kRowsN], s_mth[kRowsN];
  const int v = blockIdx.z;
  const int n0 = blockIdx.y * kRowsN;
  const int rows = min(kRowsN, N - n0);
  const int j = blockIdx.x * kThreadsJ + threadIdx.x;

  if (threadIdx.x < rows) {
    const size_t n = static_cast<size_t>(v) * N + n0 + threadIdx.x;
    const float th = ref[3 * n + 2];
    s_x[threadIdx.x] = ref[3 * n];
    s_y[threadIdx.x] = ref[3 * n + 1];
    s_th[threadIdx.x] = th;
    s_c[threadIdx.x] = cosf(th);
    s_s[threadIdx.x] = sinf(th);
    s_mx[threadIdx.x] = mu[3 * n];
    s_my[threadIdx.x] = mu[3 * n + 1];
    s_mth[threadIdx.x] = mu[3 * n + 2];
  }
  __syncthreads();
  if (j >= Nj) return;

  const size_t pj = static_cast<size_t>(v) * Nj + j;
  const float px = pts[3 * pj], py = pts[3 * pj + 1], pth = pts[3 * pj + 2];
  const float iv0 = inv_var[3 * v], iv1 = inv_var[3 * v + 1], iv2 = inv_var[3 * v + 2];
  float* o = out + (static_cast<size_t>(v) * N + n0) * Nj + j;
  for (int r = 0; r < rows; ++r) {
    const float dx = px - s_x[r];
    const float dy = py - s_y[r];
    const float cx = s_c[r] * dx + s_s[r] * dy;
    const float cy = s_c[r] * dy - s_s[r] * dx;
    const float a = pth - s_th[r];
    const float wrapped = a - kTwoPi * floor_turns(a);
    const float ex = cx - s_mx[r];
    const float ey = cy - s_my[r];
    const float eth = wrapped - s_mth[r];
    o[static_cast<size_t>(r) * Nj] =
        -0.5f * (iv0 * ex * ex + iv1 * ey * ey + iv2 * eth * eth);
  }
}

__global__ void euclid_pairwise_logw_kernel(
    const float* __restrict__ ref, const float* __restrict__ mu,
    const float* __restrict__ pts, const float* __restrict__ inv_var,
    const float* __restrict__ circ, float* __restrict__ out, int N, int Nj,
    int dof) {
  __shared__ float s_ref[kRowsN][kMaxDof], s_mu[kRowsN][kMaxDof];
  const int v = blockIdx.z;
  const int n0 = blockIdx.y * kRowsN;
  const int rows = min(kRowsN, N - n0);
  const int j = blockIdx.x * kThreadsJ + threadIdx.x;

  if (threadIdx.x < rows * dof) {
    const int r = threadIdx.x / dof, d = threadIdx.x % dof;
    const size_t e = (static_cast<size_t>(v) * N + n0 + r) * dof + d;
    s_ref[r][d] = ref[e];
    s_mu[r][d] = mu[e];
  }
  __syncthreads();
  if (j >= Nj) return;

  float p[kMaxDof], iv[kMaxDof], c2pi[kMaxDof];
  const size_t pj = (static_cast<size_t>(v) * Nj + j) * dof;
#pragma unroll
  for (int d = 0; d < kMaxDof; ++d) {
    if (d < dof) {
      p[d] = pts[pj + d];
      iv[d] = inv_var[static_cast<size_t>(v) * dof + d];
      c2pi[d] = circ[d] * kTwoPi;
    }
  }
  float* o = out + (static_cast<size_t>(v) * N + n0) * Nj + j;
  for (int r = 0; r < rows; ++r) {
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < kMaxDof; ++d) {
      if (d < dof) {
        float diff = p[d] - s_ref[r][d];
        diff = diff - c2pi[d] * floor_turns(diff);
        const float e = diff - s_mu[r][d];
        acc = acc + iv[d] * e * e;
      }
    }
    o[static_cast<size_t>(r) * Nj] = -0.5f * acc;
  }
}

dim3 grid_of(int V, int N, int Nj) {
  return dim3((Nj + kThreadsJ - 1) / kThreadsJ, (N + kRowsN - 1) / kRowsN, V);
}

}  // namespace

extern "C" int rome_se2_pairwise_logw(
    const float* ref, const float* mu, const float* pts, const float* inv_var,
    float* out, int V, int N, int Nj, cudaStream_t stream) {
  if (V > 0 && N > 0 && Nj > 0) {
    se2_pairwise_logw_kernel<<<grid_of(V, N, Nj), kThreadsJ, 0, stream>>>(
        ref, mu, pts, inv_var, out, N, Nj);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rome_euclid_pairwise_logw(
    const float* ref, const float* mu, const float* pts, const float* inv_var,
    const float* circ, float* out, int V, int N, int Nj, int dof,
    cudaStream_t stream) {
  if (dof < 1 || dof > kMaxDof) return static_cast<int>(cudaErrorInvalidValue);
  if (V > 0 && N > 0 && Nj > 0) {
    euclid_pairwise_logw_kernel<<<grid_of(V, N, Nj), kThreadsJ, 0, stream>>>(
        ref, mu, pts, inv_var, circ, out, N, Nj, dof);
  }
  return static_cast<int>(cudaGetLastError());
}
