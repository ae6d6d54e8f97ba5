// Batched cyclic Jacobi eigendecomposition of the leaf and edge blocks of
// the spectral divide-and-conquer eigensolver: f32 [b, m, m], even m from 2
// to 160 (the wrapper pads an odd m by one decoupled zero row and column).
//
// Stands for the JAX package's leaf solves at these sizes,
// vivit_tpu/eigdc.py:_leaf_eigh, which reaches
// vivit_tpu/kernels/jacobi.py:batched_eigh_xla (jnp.linalg.eigh) there: one
// step of the compiled program on the TPU.  On the card the vendor's eigh
// reads cuSOLVER's status on the host and so cannot sit inside a CUDA
// graph; this kernel can.  It computes the function of the plain version
// jacobi_cuda.batched_eigh_jacobi_plain: symmetrise, then up to
// `max_sweeps` sweeps of the round-robin ordering of
// jacobi_cuda.round_robin_pairs with the rotation formulas of `_rot_from`
// (copysign 45-degree rotation at tau == 0, identity when
// |a_pq| <= 1e-30), the pivot block in Rutishauser's form, and the exact
// early exit after the first sweep without a rotation.  Every product and
// sum is rounded as the plain version rounds it (IEEE sqrtf and /, and the
// build passes --fmad=false), so the two agree bit for bit.  The window
// kernel (csrc/jacobi.cu) computes the same function for m in {32, 48, 64}.
//
// What bounds it on an H100: one CTA owns one matrix, and a sweep is a
// chain of m-1 dependent parallel steps, each a barrier-separated pass over
// A and V in shared memory.  A step at m=150 moves ~90k words through
// shared memory (every 2x2 block of A read and written once, every pair of
// V's columns once): ~2.8k cycles at 32 words a cycle, microseconds, while
// its arithmetic (~0.2 MFLOP) is far below the SM's rate.  So the kernel is
// bound by the shared-memory traffic and the latency of one step, times
// (m-1) steps times the sweeps, on b of the 132 SMs: 16 of 132 at the
// N=128 leaves [16,150,150], one at the bottom block [1,96,96].
//
// What the design does about it:
//
// * A and V live in dynamic shared memory, unpadded (2 * 160^2 * 4 =
//   204,800 B at m=160, under the 232,448 B a block may have; the limit is
//   raised once per device before the first launch, outside any capture),
//   so nothing goes back to device memory until the end.
// * A is updated in place.  The m/2 rotations of a step are disjoint, so
//   J^T A J splits into independent 2x2 blocks: block (k, l) at rows
//   (p_k, q_k) and columns (p_l, q_l) becomes J_k^T A_kl J_l, the row
//   update and then the column update of the plain version, and no other
//   block reads or writes it.  The window kernel ping-pongs A between two
//   buffers because its rotation warp reads the next step's pivots while
//   the bulk writes; that would need 307 KB here.  In its place each step
//   takes two barriers: one after its rotations, one after its update.
// * The rotations: thread j < m/2 computes pair j's (p, q) from the
//   round-robin formula (no schedule table, so nothing is copied from the
//   host, and nothing is made at first use inside a capture) and its
//   rotation from A, and leaves both in shared memory.
// * The update: warp w takes the block rows k = w, w+32, ..., its lane the
//   pairs l = lane, lane+32, lane+64, whose columns and rotations it keeps
//   in registers for the step; V <- V J goes by (row, pair) the same way.
//   A warp's lanes touch one row at distinct columns.
// * An exact early exit: a matrix stops after the first sweep in which
//   every rotation was the identity (__syncthreads_or of a flag as that
//   sweep's last barrier), as the window kernel does; the sweeps run go to
//   `sweeps_run`.
//
// Later work: several CTAs (a cluster over distributed shared memory) per
// matrix to use more than b of the SMs, and the m > 160 blocks whose A and
// V no longer fit one block's shared memory.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxM = 160;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// the pairs of one lane: lane, lane + 32, lane + 64 (m/2 <= 80)
constexpr int kLanePairs = (kMaxM / 2 + 31) / 32;

size_t shared_bytes(int m) {
  const int h = m / 2;
  return h * (sizeof(float4) + sizeof(int2)) + 2 * static_cast<size_t>(m) * m * sizeof(float);
}

struct Rotation {
  float c, s, dp, dq;
  bool small;
};

// The rotation that annihilates apq, as `_rot_from`, and the pivot block's
// new diagonal in Rutishauser's form.
__device__ __forceinline__ Rotation rotation(float app, float aqq, float apq) {
  Rotation rot;
  rot.small = fabsf(apq) <= 1e-30f;
  const float tau = (aqq - app) / (rot.small ? 1.0f : 2.0f * apq);
  float t = (tau >= 0.0f ? 1.0f : -1.0f) / (fabsf(tau) + sqrtf(1.0f + tau * tau));
  if (rot.small) t = 0.0f;
  rot.c = 1.0f / sqrtf(1.0f + t * t);
  rot.s = t * rot.c;
  rot.dp = app - t * apq;
  rot.dq = aqq + t * apq;
  return rot;
}

// The index at position `pos` of step r (round_robin_pairs): position 0
// holds 0, positions 1..m-1 the other indices rotated by the step.
__device__ __forceinline__ int player(int pos, int r, int m) {
  if (pos == 0) return 0;
  int v = pos - 1 + r;
  if (v >= m - 1) v -= m - 1;
  return v + 1;
}

__global__ void __launch_bounds__(kThreads, 1)
leaf_eigh_kernel(const float* __restrict__ A, float* __restrict__ evals,
                 float* __restrict__ evecs, int* __restrict__ sweeps_run, int m,
                 int max_sweeps) {
  extern __shared__ float4 smem[];
  const int h = m / 2;
  float4* rot = smem;                                   // [h] c, s, dp, dq
  int2* pairs = reinterpret_cast<int2*>(rot + h);       // [h] p, q
  float* a = reinterpret_cast<float*>(pairs + h);       // [m, m]
  float* v = a + m * m;                                 // [m, m]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* Ab = A + static_cast<size_t>(blockIdx.x) * m * m;
  for (int idx = tid; idx < m * m; idx += kThreads) {
    const int i = idx / m, j = idx - i * m;
    a[idx] = 0.5f * (Ab[idx] + Ab[j * m + i]);
    v[idx] = (i == j) ? 1.0f : 0.0f;
  }
  __syncthreads();

  int sweep = 0;
  while (sweep < max_sweeps) {
    ++sweep;
    int rotated = 0;
    for (int r = 0; r < m - 1; ++r) {
      // the step's rotations: thread j holds pair j
      if (tid < h) {
        const int x = player(tid, r, m), y = player(m - 1 - tid, r, m);
        const int p = min(x, y), q = max(x, y);
        const Rotation rt = rotation(a[p * m + p], a[q * m + q], a[p * m + q]);
        rotated |= !rt.small;
        rot[tid] = make_float4(rt.c, rt.s, rt.dp, rt.dq);
        pairs[tid] = make_int2(p, q);
      }
      __syncthreads();

      // this lane's pairs l: their columns and rotations
      int pl[kLanePairs], ql[kLanePairs];
      float4 rl[kLanePairs];
#pragma unroll
      for (int u = 0; u < kLanePairs; ++u) {
        const int l = lane + 32 * u;
        if (l < h) {
          const int2 e = pairs[l];
          pl[u] = e.x;
          ql[u] = e.y;
          rl[u] = rot[l];
        }
      }
      // A <- J^T A J in place, block (k, l) = J_k^T A_kl J_l; a diagonal
      // block (k == l) takes the pivot block instead
      for (int k = warp; k < h; k += kWarps) {
        const int2 ek = pairs[k];
        const float4 rk = rot[k];
        float* row_p = a + ek.x * m;
        float* row_q = a + ek.y * m;
#pragma unroll
        for (int u = 0; u < kLanePairs; ++u) {
          const int l = lane + 32 * u;
          if (l >= h) break;
          if (l == k) {
            row_p[pl[u]] = rk.z;
            row_p[ql[u]] = 0.0f;
            row_q[pl[u]] = 0.0f;
            row_q[ql[u]] = rk.w;
            continue;
          }
          const float a00 = row_p[pl[u]], a01 = row_p[ql[u]];
          const float a10 = row_q[pl[u]], a11 = row_q[ql[u]];
          const float ck = rk.x, sk = rk.y, cl = rl[u].x, sl = rl[u].y;
          const float r00 = ck * a00 - sk * a10, r01 = ck * a01 - sk * a11;
          const float r10 = sk * a00 + ck * a10, r11 = sk * a01 + ck * a11;
          row_p[pl[u]] = cl * r00 - sl * r01;
          row_p[ql[u]] = sl * r00 + cl * r01;
          row_q[pl[u]] = cl * r10 - sl * r11;
          row_q[ql[u]] = sl * r10 + cl * r11;
        }
      }
      // V <- V J in place: row i, columns (p_l, q_l)
      for (int i = warp; i < m; i += kWarps) {
        float* row = v + i * m;
#pragma unroll
        for (int u = 0; u < kLanePairs; ++u) {
          if (lane + 32 * u >= h) break;
          const float xp = row[pl[u]], xq = row[ql[u]];
          row[pl[u]] = rl[u].x * xp - rl[u].y * xq;
          row[ql[u]] = rl[u].y * xp + rl[u].x * xq;
        }
      }
      // the next step's rotations read what this step wrote
      if (r + 1 < m - 1) __syncthreads();
    }
    if (!__syncthreads_or(rotated)) break;
  }

  float* eb = evals + static_cast<size_t>(blockIdx.x) * m;
  float* vb = evecs + static_cast<size_t>(blockIdx.x) * m * m;
  for (int idx = tid; idx < m * m; idx += kThreads) {
    vb[idx] = v[idx];
  }
  for (int i = tid; i < m; i += kThreads) eb[i] = a[i * m + i];
  if (tid == 0) sweeps_run[blockIdx.x] = sweep;
}

}  // namespace

// Raise the kernel's dynamic shared memory limit to what m = 160 needs, on
// the current device.  Called once per device before its first launch.
extern "C" int vivit_jacobi_leaf_prepare() {
  return static_cast<int>(cudaFuncSetAttribute(
      leaf_eigh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared_bytes(kMaxM))));
}

// A [batch, m, m] -> evals [batch, m] (unsorted diagonal), evecs [batch, m, m]
// (row-major, eigenvectors in columns), sweeps_run [batch] (int32).  All
// contiguous on the device; m even, 2 <= m <= 160.  Launches on `stream` and
// returns cudaGetLastError() of the launch.
extern "C" int vivit_jacobi_leaf_eigh_f32(const float* A, float* evals, float* evecs,
                                          int* sweeps_run, int batch, int m,
                                          int max_sweeps, void* stream) {
  if (batch <= 0) return 0;
  if (m < 2 || m > kMaxM || m % 2 || max_sweeps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  leaf_eigh_kernel<<<batch, kThreads, shared_bytes(m), static_cast<cudaStream_t>(stream)>>>(
      A, evals, evecs, sweeps_run, m, max_sweeps);
  return static_cast<int>(cudaGetLastError());
}
