// Batched cyclic Jacobi eigendecomposition of small symmetric f32 matrices.
//
// Replaces the Pallas TPU kernel vivit_tpu/kernels/jacobi_pallas.py
// (batched_eigh_jacobi).  It computes the same function: symmetrise each
// [m, m] matrix, run `sweeps` parallel Jacobi sweeps with the rotation
// formulas of `_rot_from` (copysign 45-degree rotation at tau == 0, identity
// when |a_pq| <= 1e-30), and return the diagonal and the accumulated
// rotations V (columns are eigenvectors).  Sorting happens in the wrapper,
// as it does outside the pallas_call in the JAX package.  The pivot block
// is written in Rutishauser's form (a_pp - t*a_pq, a_qq + t*a_pq, zeros):
// the diagonal never passes through (c, s), whose c^2 + s^2 differs from 1
// by an ulp and would otherwise drift the eigenvalues over the sweeps.
//
// Ordering: the round-robin ("circle method") tournament.  Position 0 holds
// index 0; positions 1..m-1 hold the other indices rotated by the step
// number, and pair k joins positions k and m-1-k.  Every sweep of m-1
// parallel steps meets every pair exactly once.  The TPU kernel's
// odd-even transposition with fold-in swaps and its de-interleaved
// quadrant layout exist for the TPU's vector unit and are not carried over.
//
// What bounds it on Hopper: one CTA owns one matrix, and the sweeps are a
// chain of sweeps*(m-1) dependent parallel steps (372 at m=32, 12 sweeps),
// each three block-wide barriers apart.  The arithmetic is ~2.4 MFLOP per
// 32x32 matrix, microseconds at the card's f32 rate, so the kernel is
// latency-bound on that chain, not bound by bytes or operations.  The design
// keeps A and V in shared memory for the whole run (2*m*(m+1)*4 B, under
// 34 KB at m=64, static allocation), so no step touches device memory, and
// pads rows to m+1 floats so the column pass is free of bank conflicts.
// At the headline window batches (37 and 36 matrices) under a third of the
// 132 SMs have work; packing several matrices per CTA or splitting one
// matrix across a cluster is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxM = 64;
constexpr int kLd = kMaxM + 1;
constexpr int kThreads = 256;

__device__ __forceinline__ int player(int pos, int step, int m) {
  return pos == 0 ? 0 : ((pos - 1 + step) % (m - 1)) + 1;
}

__global__ void __launch_bounds__(kThreads)
jacobi_kernel(const float* __restrict__ A, float* __restrict__ evals,
              float* __restrict__ evecs, int m, int sweeps) {
  __shared__ float a[kMaxM * kLd];
  __shared__ float v[kMaxM * kLd];
  __shared__ float cs[kMaxM / 2];
  __shared__ float sn[kMaxM / 2];
  __shared__ float dp[kMaxM / 2];
  __shared__ float dq[kMaxM / 2];
  __shared__ int pp[kMaxM / 2];
  __shared__ int qq[kMaxM / 2];

  const int tid = threadIdx.x;
  const int h = m / 2;
  const float* Ab = A + static_cast<size_t>(blockIdx.x) * m * m;

  for (int idx = tid; idx < m * m; idx += kThreads) {
    const int i = idx / m, j = idx % m;
    a[i * kLd + j] = 0.5f * (Ab[i * m + j] + Ab[j * m + i]);
    v[i * kLd + j] = (i == j) ? 1.0f : 0.0f;
  }
  __syncthreads();

  const int steps = sweeps * (m - 1);
  for (int step = 0; step < steps; ++step) {
    const int r = step % (m - 1);
    if (tid < h) {
      const int x = player(tid, r, m), y = player(m - 1 - tid, r, m);
      const int p = min(x, y), q = max(x, y);
      const float app = a[p * kLd + p];
      const float aqq = a[q * kLd + q];
      const float apq = a[p * kLd + q];
      const bool small = fabsf(apq) <= 1e-30f;
      const float tau = (aqq - app) / (small ? 1.0f : 2.0f * apq);
      float t = (tau >= 0.0f ? 1.0f : -1.0f) /
                (fabsf(tau) + sqrtf(1.0f + tau * tau));
      if (small) t = 0.0f;
      const float c = 1.0f / sqrtf(1.0f + t * t);
      cs[tid] = c;
      sn[tid] = t * c;
      dp[tid] = app - t * apq;
      dq[tid] = aqq + t * apq;
      pp[tid] = p;
      qq[tid] = q;
    }
    __syncthreads();

    // rows: A <- J^T A (pairs are disjoint, so all rotations commute)
    for (int idx = tid; idx < h * m; idx += kThreads) {
      const int k = idx / m, j = idx % m;
      const int p = pp[k], q = qq[k];
      const float c = cs[k], s = sn[k];
      const float xp = a[p * kLd + j], xq = a[q * kLd + j];
      a[p * kLd + j] = c * xp - s * xq;
      a[q * kLd + j] = s * xp + c * xq;
    }
    __syncthreads();

    // columns: A <- A J and V <- V J; the pivot block of A exactly
    for (int idx = tid; idx < 2 * h * m; idx += kThreads) {
      const bool on_a = idx < h * m;
      float* M = on_a ? a : v;
      const int rem = idx % (h * m);
      const int k = rem / m, i = rem % m;
      const int p = pp[k], q = qq[k];
      if (on_a && i == p) {
        a[p * kLd + p] = dp[k];
        a[p * kLd + q] = 0.0f;
      } else if (on_a && i == q) {
        a[q * kLd + p] = 0.0f;
        a[q * kLd + q] = dq[k];
      } else {
        const float c = cs[k], s = sn[k];
        const float xp = M[i * kLd + p], xq = M[i * kLd + q];
        M[i * kLd + p] = c * xp - s * xq;
        M[i * kLd + q] = s * xp + c * xq;
      }
    }
    __syncthreads();
  }

  float* eb = evals + static_cast<size_t>(blockIdx.x) * m;
  float* vb = evecs + static_cast<size_t>(blockIdx.x) * m * m;
  for (int idx = tid; idx < m * m; idx += kThreads) {
    const int i = idx / m, j = idx % m;
    vb[i * m + j] = v[i * kLd + j];
    if (i == j) eb[i] = a[i * kLd + i];
  }
}

}  // namespace

// A [batch, m, m] -> evals [batch, m] (unsorted diagonal), evecs [batch, m, m]
// (row-major, eigenvectors in columns).  All three contiguous f32 on the
// device; m even, 2 <= m <= 64.  Launches on `stream` and returns
// cudaGetLastError() of the launch.
extern "C" int vivit_jacobi_eigh_f32(const float* A, float* evals,
                                     float* evecs, int batch, int m,
                                     int sweeps, void* stream) {
  if (batch <= 0) return 0;
  if (m < 2 || m > kMaxM || (m & 1)) return static_cast<int>(cudaErrorInvalidValue);
  jacobi_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, evals, evecs, m, sweeps);
  return static_cast<int>(cudaGetLastError());
}
