// Batched cyclic Jacobi eigendecomposition of small symmetric f32 matrices.
//
// Replaces the Pallas TPU kernel vivit_tpu/kernels/jacobi_pallas.py:178
// (batched_eigh_jacobi).  It computes the same function: symmetrise each
// [m, m] matrix, run up to `max_sweeps` parallel Jacobi sweeps with the
// rotation formulas of `_rot_from` (copysign 45-degree rotation at
// tau == 0, identity when |a_pq| <= 1e-30), and return the diagonal and the
// accumulated rotations V (columns are eigenvectors).  Sorting happens in
// the wrapper, as it does outside the pallas_call in the JAX package.  The
// pivot block is written in Rutishauser's form (a_pp - t*a_pq,
// a_qq + t*a_pq, zeros): the diagonal never passes through (c, s), whose
// c^2 + s^2 differs from 1 by an ulp and would otherwise drift the
// eigenvalues over the sweeps.
//
// Ordering: the round-robin ("circle method") tournament of
// jacobi_cuda.round_robin_pairs.  The wrapper hands the kernel one sweep's
// schedule (jacobi_cuda.schedule_table), and each CTA turns it into tables
// of byte offsets in shared memory once.  The TPU kernel's odd-even
// transposition with fold-in swaps and its de-interleaved quadrant layout
// exist for the TPU's vector unit and are not carried over.
//
// What bounds it on Hopper: one CTA owns one matrix in shared memory, and
// the sweeps are a chain of up to 12*(m-1) dependent parallel steps.  The
// arithmetic is ~2.4 MFLOP per 32x32 matrix, microseconds at the card's
// f32 rate, so the kernel is bound by the latency of one step: one barrier
// plus one 2x2 update, behind the rotation of the step's pairs, whose five
// IEEE divisions and square roots are one dependent chain.  What the
// design does about each part of that step:
//
// * m is a template parameter (32, 48, 64: the sizes the dispatch envelope
//   sends), so every index is shifts and constants, with no division or
//   modulo by a runtime value in the step loop.  Each pair's rows and
//   columns come as byte offsets from a shared table, an element's address
//   being one add, and each step's entries are read during the step before.
// * One block-wide barrier per parallel step.  The m/2 rotations of a step
//   are disjoint, so J^T A J splits into independent 2x2 blocks: block
//   (k, l) at rows (p_k, q_k) and columns (p_l, q_l) becomes J_k^T A_kl J_l.
//   The bulk threads compute every one of the (m/2)^2 blocks, rows first and
//   then columns, as the plain version does, and update V in place by
//   (row, pair), since the pair columns of a step are disjoint.  A
//   ping-pongs between two shared buffers, so reading step s never races
//   writing step s+1.
// * The rotations are off the bulk's path.  One extra warp, the rotation
//   warp, holds the rotation of pair j in lane j.  During step s it
//   computes the pivot a_p'q' of each pair of step s+1 from the 2x2 block
//   of step s that holds it, exactly as the bulk thread of that block does,
//   and the rotation of step s+1 from it, while the bulk threads apply step
//   s's rotations, which they read from shared memory.  So no thread waits
//   for a rotation after the barrier, and the rotations are computed once
//   instead of once per warp.  The rotation warp's pivot loads go first: the
//   bulk threads wait on a named barrier that it arrives at once they are
//   in, so its loads do not queue behind theirs.
// * An exact early exit.  A matrix stops at the end of the first sweep in
//   which every rotation was the identity (__syncthreads_or of a flag as
//   that sweep's last barrier).  Every later sweep would be exactly the
//   identity (c = 1, s = 0, all off-diagonals already 0), so the result is
//   that of running all sweeps.  The number of sweeps each matrix ran goes
//   to `sweeps_run`.
// * IEEE sqrtf and / in the rotation, and no multiply-add contraction
//   (the build passes --fmad=false): the kernel rounds every operation as
//   the plain version does, and returns its results bit for bit.
// * Rows are padded to m+1 floats.  A, V and the tables take 147,712 B at
//   m=64, above the 48 KB of static shared memory, so shared memory is
//   dynamic, with its limit raised before each launch.
//
// At the headline window batches (37 and 36 matrices) under a third of the
// 132 SMs have work; packing several matrices per CTA or splitting one
// matrix across a cluster is later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// Threads of the CTA for each compiled m, besides the rotation warp: every
// one takes the same number of 2x2 blocks of A ((m/2)^2 in all) and of
// (row, pair) items of V (m*m/2).
template <int M> struct Threads;
template <> struct Threads<32> { static constexpr int value = 256; };
template <> struct Threads<48> { static constexpr int value = 288; };
template <> struct Threads<64> { static constexpr int value = 512; };

// Byte offsets of one pair (p, q) in a padded [m, m+1] buffer: rows p and q,
// columns p and q.  An element's address is one add of a row and a column.
struct PairOffsets {
  int row_p, row_q, col_p, col_q;
};

// Where the rotation warp finds, at one step, the next step's pivot a_p'q'
// of its pair: the byte offsets of the current step's 2x2 block (kr, kc)
// that holds it, and kr | a << 5 | kc << 6 | b << 11 (a, b: the side of
// p' in pair kr and of q' in pair kc, 0 for p and 1 for q).
struct alignas(16) Ahead {
  int off[4];
  int meta;
};

template <int M>
constexpr size_t shared_bytes() {
  return 3 * M * (M + 1) * sizeof(float) +
         (M - 1) * (M / 2) * (sizeof(PairOffsets) + sizeof(Ahead)) +
         2 * (M / 2) * sizeof(float4);
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

__device__ __forceinline__ float lane_of(float x, int src) {
  return __shfl_sync(0xffffffffu, x, src);
}

__device__ __forceinline__ float& at(char* base, int offset) {
  return *reinterpret_cast<float*>(base + offset);
}

template <int M>
__global__ void __launch_bounds__(Threads<M>::value + 32)
jacobi_kernel(const float* __restrict__ A, const int* __restrict__ schedule,
              float* __restrict__ evals, float* __restrict__ evecs,
              int* __restrict__ sweeps_run, int max_sweeps) {
  constexpr int T = Threads<M>::value;  // the bulk threads
  constexpr int H = M / 2;
  constexpr int LD = M + 1;
  constexpr int STEPS = M - 1;
  constexpr int BLOCKS = H * H / T;  // 2x2 blocks of A per bulk thread
  constexpr int ITEMS = M * H / T;   // (row, pair) items of V per bulk thread
  static_assert(H * H % T == 0 && M * H % T == 0, "uneven split");
  static_assert(T % 32 == 0 && H <= 32, "one warp holds every pair's rotation");
  // where H divides 32, every block and item of a bulk thread has the same
  // pair l, lane % H
  constexpr bool kOneL = 32 % H == 0;

  extern __shared__ float smem[];
  char* src = reinterpret_cast<char*>(smem);
  char* dst = reinterpret_cast<char*>(smem + M * LD);
  float* v = smem + 2 * M * LD;
  PairOffsets* table = reinterpret_cast<PairOffsets*>(smem + 3 * M * LD);
  Ahead* ahead = reinterpret_cast<Ahead*>(table + STEPS * H);
  float4* rot_buf = reinterpret_cast<float4*>(ahead + STEPS * H);  // [2][H]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool rot_warp = tid >= T;
  const float* Ab = A + static_cast<size_t>(blockIdx.x) * M * M;
  for (int idx = tid; idx < M * M; idx += T + 32) {
    const int i = idx / M, j = idx % M;
    reinterpret_cast<float*>(src)[i * LD + j] = 0.5f * (Ab[i * M + j] + Ab[j * M + i]);
    v[i * LD + j] = (i == j) ? 1.0f : 0.0f;
  }
  for (int idx = tid; idx < STEPS * H; idx += T + 32) {
    const int p = schedule[idx] & 0xff, q = (schedule[idx] >> 8) & 0xff;
    table[idx] = {static_cast<int>(p * LD * sizeof(float)),
                  static_cast<int>(q * LD * sizeof(float)),
                  static_cast<int>(p * sizeof(float)),
                  static_cast<int>(q * sizeof(float))};
  }
  __syncthreads();
  for (int idx = tid; idx < STEPS * H; idx += T + 32) {
    const int meta = schedule[idx] >> 16;
    const PairOffsets* pairs = table + idx / H * H;
    const PairOffsets kr = pairs[meta & 31], kc = pairs[(meta >> 6) & 31];
    ahead[idx] = {{kr.row_p + kc.col_p, kr.row_p + kc.col_q,
                   kr.row_q + kc.col_p, kr.row_q + kc.col_q}, meta};
  }
  __syncthreads();

  // A bulk thread's blocks (k, l) of A and items (row, l) of V
  int bk[BLOCKS], bl[BLOCKS], vl[ITEMS];
  char* vrow[ITEMS];
#pragma unroll
  for (int i = 0; i < BLOCKS; ++i) {
    bk[i] = (tid + i * T) / H;
    bl[i] = (tid + i * T) % H;
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    vl[i] = (tid + i * T) % H;
    vrow[i] = reinterpret_cast<char*>(v + (tid + i * T) / H * LD);
  }
  struct BulkPairs {
    PairOffsets k[BLOCKS], l[BLOCKS], v[ITEMS];
  };
  auto bulk_pairs = [&](int r) {
    const PairOffsets* pairs = table + r * H;
    BulkPairs out;
#pragma unroll
    for (int i = 0; i < BLOCKS; ++i) {
      out.k[i] = pairs[bk[i]];
      out.l[i] = kOneL && i > 0 ? out.l[0] : pairs[bl[i]];
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) out.v[i] = kOneL ? out.l[0] : pairs[vl[i]];
    return out;
  };

  // The rotation warp: lane j < H holds the rotation of pair j at the
  // current step, and computes the next step's while the bulk threads apply
  // the current one.
  const int own = lane % H;
  Rotation cur;
  Ahead look;
  BulkPairs bp;
  if (rot_warp) {
    const PairOffsets po = table[own];
    cur = rotation(at(src, po.row_p + po.col_p), at(src, po.row_q + po.col_q),
                   at(src, po.row_p + po.col_q));
    if (lane < H) rot_buf[lane] = make_float4(cur.c, cur.s, cur.dp, cur.dq);
    look = ahead[own];
  } else {
    bp = bulk_pairs(0);
  }
  __syncthreads();

  int sweep = 0, parity = 0;
  while (sweep < max_sweeps) {
    ++sweep;
    int rotated = 0;
    for (int r = 0; r < STEPS; ++r) {
      const int next_r = r + 1 < STEPS ? r + 1 : 0;
      if (rot_warp) {
        // the next step's pivot of pair `own`, computed as the bulk threads
        // compute that element of A, then its rotation
        rotated |= !cur.small;
        const Ahead here = look;
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) e[i] = at(src, here.off[i]);
        look = ahead[next_r * H + own];
        const int kr = here.meta & 31, a = (here.meta >> 5) & 1;
        const int kc = (here.meta >> 6) & 31, b = (here.meta >> 11) & 1;
        const float ckr = lane_of(cur.c, kr), skr = lane_of(cur.s, kr);
        const float ckc = lane_of(cur.c, kc), skc = lane_of(cur.s, kc);
        const float dpr = lane_of(cur.dp, kr), dqr = lane_of(cur.dq, kr);
        const float dpc = lane_of(cur.dp, kc), dqc = lane_of(cur.dq, kc);
        const float r0 = a ? skr * e[0] + ckr * e[2] : ckr * e[0] - skr * e[2];
        const float r1 = a ? skr * e[1] + ckr * e[3] : ckr * e[1] - skr * e[3];
        const float apq = b ? skc * r0 + ckc * r1 : ckc * r0 - skc * r1;
        // the pivot's loads are in: the bulk threads may start theirs
        asm volatile("bar.arrive 1, %0;" ::"n"(T + 32) : "memory");
        cur = rotation(a ? dqr : dpr, b ? dqc : dpc, apq);
        if (lane < H) {
          rot_buf[(parity ^ 1) * H + lane] = make_float4(cur.c, cur.s, cur.dp, cur.dq);
        }
      } else {
        // the rotation warp's loads go first, ahead of the bulk's queue
        asm volatile("bar.sync 1, %0;" ::"n"(T + 32) : "memory");
        const BulkPairs here = bp;
        const PairOffsets *pk = here.k, *pl = here.l, *pv = here.v;
        const float4* rots = rot_buf + parity * H;
        // all loads first, then the arithmetic and the stores
        float a00[BLOCKS], a01[BLOCKS], a10[BLOCKS], a11[BLOCKS];
        float4 rk[BLOCKS], rl[BLOCKS];
#pragma unroll
        for (int i = 0; i < BLOCKS; ++i) {
          a00[i] = at(src, pk[i].row_p + pl[i].col_p);
          a01[i] = at(src, pk[i].row_p + pl[i].col_q);
          a10[i] = at(src, pk[i].row_q + pl[i].col_p);
          a11[i] = at(src, pk[i].row_q + pl[i].col_q);
          rk[i] = rots[bk[i]];
          rl[i] = kOneL && i > 0 ? rl[0] : rots[bl[i]];
        }
        float xp[ITEMS], xq[ITEMS];
        float4 rv[ITEMS];
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
          xp[i] = at(vrow[i], pv[i].col_p);
          xq[i] = at(vrow[i], pv[i].col_q);
          rv[i] = kOneL ? rl[0] : rots[vl[i]];
        }
        // A <- J^T A J, block (k, l) = J_k^T A_kl J_l into the other
        // buffer; a diagonal block (k == l) takes the pivot block instead
#pragma unroll
        for (int i = 0; i < BLOCKS; ++i) {
          const float ck = rk[i].x, sk = rk[i].y, cl = rl[i].x, sl = rl[i].y;
          const bool pivot = bk[i] == bl[i];
          const float r00 = ck * a00[i] - sk * a10[i], r01 = ck * a01[i] - sk * a11[i];
          const float r10 = sk * a00[i] + ck * a10[i], r11 = sk * a01[i] + ck * a11[i];
          at(dst, pk[i].row_p + pl[i].col_p) = pivot ? rl[i].z : cl * r00 - sl * r01;
          at(dst, pk[i].row_p + pl[i].col_q) = pivot ? 0.0f : sl * r00 + cl * r01;
          at(dst, pk[i].row_q + pl[i].col_p) = pivot ? 0.0f : cl * r10 - sl * r11;
          at(dst, pk[i].row_q + pl[i].col_q) = pivot ? rl[i].w : sl * r10 + cl * r11;
        }
        // V <- V J in place: row `vrow`, columns (p_l, q_l)
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
          at(vrow[i], pv[i].col_p) = rv[i].x * xp[i] - rv[i].y * xq[i];
          at(vrow[i], pv[i].col_q) = rv[i].y * xp[i] + rv[i].x * xq[i];
        }
        bp = bulk_pairs(next_r);
      }
      char* tmp = src;
      src = dst;
      dst = tmp;
      parity ^= 1;
      if (r + 1 < STEPS) __syncthreads();
    }
    if (!__syncthreads_or(rotated)) break;
  }

  const float* a = reinterpret_cast<const float*>(src);
  float* eb = evals + static_cast<size_t>(blockIdx.x) * M;
  float* vb = evecs + static_cast<size_t>(blockIdx.x) * M * M;
  for (int idx = tid; idx < M * M; idx += T + 32) {
    const int i = idx / M, j = idx % M;
    vb[i * M + j] = v[i * LD + j];
    if (i == j) eb[i] = a[i * LD + i];
  }
  if (tid == 0) sweeps_run[blockIdx.x] = sweep;
}

template <int M>
int launch(const float* A, const int* schedule, float* evals, float* evecs,
           int* sweeps_run, int batch, int max_sweeps, cudaStream_t stream) {
  constexpr size_t bytes = shared_bytes<M>();
  // the limit belongs to the current device's context, so it is raised at
  // every launch rather than once per process
  const cudaError_t configured = cudaFuncSetAttribute(
      jacobi_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (configured != cudaSuccess) return static_cast<int>(configured);
  jacobi_kernel<M><<<batch, Threads<M>::value + 32, bytes, stream>>>(
      A, schedule, evals, evecs, sweeps_run, max_sweeps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A [batch, m, m] -> evals [batch, m] (unsorted diagonal), evecs [batch, m, m]
// (row-major, eigenvectors in columns), sweeps_run [batch] (int32).
// `schedule` is jacobi_cuda.schedule_table(m): [m-1, m/2] int32, pair j of
// step r as p | q << 8, and the place of step r+1's pair j in step r's
// blocks as Ahead::meta << 16.
// All contiguous on the device; m is 32, 48 or 64.  Launches on `stream` and
// returns cudaGetLastError() of the launch.
extern "C" int vivit_jacobi_eigh_f32(const float* A, const int* schedule,
                                     float* evals, float* evecs,
                                     int* sweeps_run, int batch, int m,
                                     int max_sweeps, void* stream) {
  if (batch <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 32:
      return launch<32>(A, schedule, evals, evecs, sweeps_run, batch, max_sweeps, st);
    case 48:
      return launch<48>(A, schedule, evals, evecs, sweeps_run, batch, max_sweeps, st);
    case 64:
      return launch<64>(A, schedule, evals, evecs, sweeps_run, batch, max_sweeps, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
