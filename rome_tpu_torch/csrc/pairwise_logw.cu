// Gibbs pairwise scores and label draws of the nonparametric belief product
// (K2, K3), written for Hopper (sm_90a):
//
//   logw[v, n, j] = -0.5 * sum_d iv[v, d] * (local(ref[v, n], pts[v, j])_d - mu[v, n, d])^2
//   labels[v, n]  = argmax_j logw[v, n, j] - log(-log(max(u[v, n, j], FLT_MIN)))
//
// for every variable v of a type, output particle n and candidate kernel j.
// The second line is the Gumbel-max draw of one kernel label per row from
// softmax(logw[v, n, :]), given the uniforms u.
//
// Replaces the JAX package's Pallas kernels in rome_tpu/ops/pairwise.py:
// - K2 <- _se2_kernel (launched by se2_pairwise_logw): SE(2) hybrid local
//     (R(-th_r)(t_p - t_r), wrap(th_p - th_r));
// - K3 <- _euclid_kernel (launched by euclid_pairwise_logw): per-dim
//   difference, wrapped onto [-pi, pi) where circ[d] is 1, for dof <= 8;
// and, in the draw epilogue, the jax.random.categorical that XLA fuses after
// each Pallas call (rome_tpu/solvers/multimodal/batched.py:369, kde.py:263).
// The plain versions they are held to are in rome_tpu_torch/ops/pairwise.py.
//
// Two epilogues are instantiated from one score code:
// - logw: writes the (V, N, Nj) float32 scores, the Pallas kernels' contract;
// - draw: reads the (V, N, Nj) float32 uniforms u and writes only the (V, N)
//   int64 labels, so the scores never reach device memory. The solve paths
//   launch this one, once per Gibbs label update for all V variables.
//
// What bounds it on an H100: a few tens of flops per (n, j) pair against one
// 4-byte load of u (draw) or one 4-byte store of logw (logw), so the
// (V, N, Nj) float32 stream: about 4 MB at beehive-100's (101, 100, 100), a
// little over a microsecond of HBM time, and below that size the launch.
// No tensor cores and no wgmma: the score is a rank-dof (<= 8) quadratic form
// with an angle wrap per pair, not a matrix product.
//
// Design:
// - one warp per output row (v, n); its lanes stride over j (lane, lane + 32,
//   ...), so the loads of u and the stores of logw are coalesced along Nj.
//   The row's ref, mu and inv_var (and K2's cos/sin of th_r) sit in
//   registers. A lane issues the loads of its next 4 uniforms before it
//   uses any (128 candidates per warp step): a draw is bound by the latency
//   of those loads, not by their bytes.
// - grid (ceil(N / 4), V), 4 warps per block. The block stages the
//   variable's candidate points pts[v] in shared memory with cp.async,
//   transposed to one row per dim so that neighbouring lanes read
//   neighbouring words, in tiles of up to 1024 points (32 KB at dof 8); the
//   row set-up overlaps the copy.
// - draw: each lane keeps a running (best value, best j); a __shfl_xor_sync
//   reduction ends the row. Ties go to the lower j and NaN counts as the
//   largest value, as torch.argmax decides (its first index).
// - the ragged N and Nj edges are masked; nothing is padded to the TPU's
//   (8, 128) tiles.
// Accuracy: built without --use_fast_math. The wrap is
// x - 2pi * floorf((x + pi) / (2pi)) with an IEEE division, as the Pallas
// kernel computes it, so an angle at +-pi wraps to the Pallas side; the
// Gumbel transform uses logf in the order of operations of kde.categorical.

#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileJ = 1024;  // candidate points per shared-memory tile
constexpr int kPerLane = 4;   // candidates a lane keeps in flight: 128 per warp step
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

__device__ __forceinline__ float floor_turns(float x) {
  return floorf(__fdiv_rn(x + kPi, kTwoPi));
}

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Candidate points of a tile: dim d of point j at pts[d * stride + j].
struct Se2Row {
  static constexpr int kDof = 3;
  float rx, ry, rth, c, s, mx, my, mth, iv0, iv1, iv2;

  __device__ __forceinline__ void load(const float* ref, const float* mu,
                                       const float* inv_var, const float* /*circ*/,
                                       size_t row, int v) {
    rx = ref[3 * row];
    ry = ref[3 * row + 1];
    rth = ref[3 * row + 2];
    c = cosf(rth);
    s = sinf(rth);
    mx = mu[3 * row];
    my = mu[3 * row + 1];
    mth = mu[3 * row + 2];
    iv0 = inv_var[3 * v];
    iv1 = inv_var[3 * v + 1];
    iv2 = inv_var[3 * v + 2];
  }

  __device__ __forceinline__ float score(const float* pts, int stride, int j) const {
    const float dx = pts[j] - rx;
    const float dy = pts[stride + j] - ry;
    const float cx = c * dx + s * dy;
    const float cy = c * dy - s * dx;
    const float a = pts[2 * stride + j] - rth;
    const float wrapped = a - kTwoPi * floor_turns(a);
    const float ex = cx - mx;
    const float ey = cy - my;
    const float eth = wrapped - mth;
    return -0.5f * (iv0 * ex * ex + iv1 * ey * ey + iv2 * eth * eth);
  }
};

template <int DOF>
struct EuclidRow {
  static constexpr int kDof = DOF;
  float r[DOF], m[DOF], iv[DOF], c2pi[DOF];

  __device__ __forceinline__ void load(const float* ref, const float* mu,
                                       const float* inv_var, const float* circ,
                                       size_t row, int v) {
#pragma unroll
    for (int d = 0; d < DOF; ++d) {
      r[d] = ref[row * DOF + d];
      m[d] = mu[row * DOF + d];
      iv[d] = inv_var[static_cast<size_t>(v) * DOF + d];
      c2pi[d] = circ[d] * kTwoPi;
    }
  }

  __device__ __forceinline__ float score(const float* pts, int stride, int j) const {
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < DOF; ++d) {
      float diff = pts[d * stride + j] - r[d];
      diff = diff - c2pi[d] * floor_turns(diff);
      const float e = diff - m[d];
      acc = acc + iv[d] * e * e;
    }
    return -0.5f * acc;
  }
};

// The uniforms of one warp step: candidate c + lane + 32 k for k < kPerLane,
// all loads issued before any is used.
__device__ __forceinline__ void load_u(float (&uu)[kPerLane], const float* __restrict__ u,
                                       int nt, int c, int lane) {
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int j = c + lane + 32 * k;
    uu[k] = j < nt ? u[j] : 1.0f;
  }
}

// Whether (v2, j2) beats (v1, j1) in torch.argmax's order: NaN is the
// largest value, and among equal values the first index wins.
__device__ __forceinline__ bool beats(float v2, int j2, float v1, int j1) {
  const bool nan1 = isnan(v1), nan2 = isnan(v2);
  if (nan1 || nan2) return nan2 && (!nan1 || j2 < j1);
  return v2 > v1 || (v2 == v1 && j2 < j1);
}

template <class Row, bool kDraw>
__global__ void __launch_bounds__(kThreads) gibbs_kernel(
    const float* __restrict__ ref, const float* __restrict__ mu,
    const float* __restrict__ pts, const float* __restrict__ inv_var,
    const float* __restrict__ circ, const float* __restrict__ u,
    float* __restrict__ logw, int64_t* __restrict__ labels, int N, int Nj, int tile) {
  constexpr int D = Row::kDof;
  extern __shared__ float s_pts[];  // [D][tile]
  const int v = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = n < N;  // the same for every lane of a warp
  const size_t row = static_cast<size_t>(v) * N + n;
  const float* vpts = pts + static_cast<size_t>(v) * Nj * D;

  Row r;
  float best = -INFINITY;
  int best_j = INT_MAX;  // loses every tie against a real candidate
  float uu[kPerLane];
  for (int j0 = 0; j0 < Nj; j0 += tile) {
    const int nt = min(tile, Nj - j0);
    const size_t base = row * Nj + j0;
    if (j0 > 0) __syncthreads();  // every warp is done with the last tile
    const float* src = vpts + static_cast<size_t>(j0) * D;
    for (int e = threadIdx.x; e < nt * D; e += kThreads) {
      cp_async_f32(&s_pts[(e % D) * tile + e / D], src + e);
    }
    // the first uniforms and the row set-up overlap the copy
    if constexpr (kDraw) {
      if (active) load_u(uu, u + base, nt, 0, lane);
    }
    if (j0 == 0 && active) r.load(ref, mu, inv_var, circ, row, v);
    cp_async_wait_all();
    __syncthreads();
    if (!active) continue;
    for (int c = 0; c < nt; c += 32 * kPerLane) {
      if constexpr (kDraw) {
        if (c > 0) load_u(uu, u + base, nt, c, lane);
      }
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int j = c + lane + 32 * k;
        if (j >= nt) break;
        const float sc = r.score(s_pts, tile, j);
        if constexpr (kDraw) {
          const float gumbel = -logf(-logf(fmaxf(uu[k], FLT_MIN)));
          const float val = sc + gumbel;
          if (beats(val, j0 + j, best, best_j)) {
            best = val;
            best_j = j0 + j;
          }
        } else {
          logw[base + j] = sc;
        }
      }
    }
  }
  if constexpr (kDraw) {
    if (!active) return;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oj = __shfl_xor_sync(0xffffffffu, best_j, off);
      if (beats(ov, oj, best, best_j)) {
        best = ov;
        best_j = oj;
      }
    }
    if (lane == 0) labels[row] = best_j;
  }
}

template <class Row, bool kDraw>
int launch(const float* ref, const float* mu, const float* pts, const float* inv_var,
           const float* circ, const float* u, float* logw, int64_t* labels, int V, int N,
           int Nj, cudaStream_t stream) {
  if (V > 0 && N > 0 && Nj > 0) {
    const int tile = Nj < kTileJ ? Nj : kTileJ;
    const dim3 grid((N + kWarps - 1) / kWarps, V);
    const size_t smem = static_cast<size_t>(tile) * Row::kDof * sizeof(float);
    gibbs_kernel<Row, kDraw><<<grid, kThreads, smem, stream>>>(
        ref, mu, pts, inv_var, circ, u, logw, labels, N, Nj, tile);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kDraw>
int launch_euclid(const float* ref, const float* mu, const float* pts,
                  const float* inv_var, const float* circ, const float* u, float* logw,
                  int64_t* labels, int V, int N, int Nj, int dof, cudaStream_t stream) {
  switch (dof) {
#define ROME_EUCLID_CASE(D)                                                       \
  case D:                                                                         \
    return launch<EuclidRow<D>, kDraw>(ref, mu, pts, inv_var, circ, u, logw, labels, \
                                       V, N, Nj, stream);
    ROME_EUCLID_CASE(1)
    ROME_EUCLID_CASE(2)
    ROME_EUCLID_CASE(3)
    ROME_EUCLID_CASE(4)
    ROME_EUCLID_CASE(5)
    ROME_EUCLID_CASE(6)
    ROME_EUCLID_CASE(7)
    ROME_EUCLID_CASE(8)
#undef ROME_EUCLID_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int rome_se2_pairwise_logw(
    const float* ref, const float* mu, const float* pts, const float* inv_var,
    float* out, int V, int N, int Nj, cudaStream_t stream) {
  return launch<Se2Row, false>(ref, mu, pts, inv_var, nullptr, nullptr, out, nullptr,
                               V, N, Nj, stream);
}

extern "C" int rome_se2_gibbs_draw(
    const float* ref, const float* mu, const float* pts, const float* inv_var,
    const float* u, int64_t* labels, int V, int N, int Nj, cudaStream_t stream) {
  return launch<Se2Row, true>(ref, mu, pts, inv_var, nullptr, u, nullptr, labels,
                              V, N, Nj, stream);
}

extern "C" int rome_euclid_pairwise_logw(
    const float* ref, const float* mu, const float* pts, const float* inv_var,
    const float* circ, float* out, int V, int N, int Nj, int dof, cudaStream_t stream) {
  return launch_euclid<false>(ref, mu, pts, inv_var, circ, nullptr, out, nullptr,
                              V, N, Nj, dof, stream);
}

extern "C" int rome_euclid_gibbs_draw(
    const float* ref, const float* mu, const float* pts, const float* inv_var,
    const float* circ, const float* u, int64_t* labels, int V, int N, int Nj, int dof,
    cudaStream_t stream) {
  return launch_euclid<true>(ref, mu, pts, inv_var, circ, u, nullptr, labels,
                             V, N, Nj, dof, stream);
}
