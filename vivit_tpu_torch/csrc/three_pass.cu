// The three-pass TF32 product of eigh_dc's large basis products on the tensor
// cores: c = a @ b for f32 a [batch, M, K] and b [batch, K, N], as
// lo_a*hi_b + hi_a*lo_b + hi_a*hi_b, each operand split into hi, its TF32
// rounding to nearest (the low 13 mantissa bits rounded off, as
// precision.tf32_split), and the exact rest lo = x - hi.
//
// Stands for no Pallas kernel: the JAX package leaves the product to XLA at
// Precision.HIGH (bf16_3x on the TPU, vivit_tpu/eigdc.py:_mm).  It replaces
// the port's cuBLAS route for an engaged "high" product (two operand splits
// written to device memory, hi*lo and lo*hi, and hi*hi in k-chunks of 384,
// each a call that reads and writes the whole output).  It computes the
// function of the plain version kernels/three_pass.py:three_pass_plain.  The
// tensor cores multiply hi exactly and lo cut to TF32; lo*lo lies below an
// f32 product's error.
//
// What bounds it on an H100: operations.  At 4608^3 the three passes are
// 587 GFLOP of TF32, 1.186 ms at 495 TFLOP/s; the operands in and the output
// out are 255 MB, 0.076 ms at 3.35 TB/s.  Shared memory comes next: at the
// tensor cores' rate wgmma reads b's tiles at 64 B a clock, half of an SM's
// 128, and TMA's writes, the split and the fragments' reads add ~95 KB a
// 32-deep stage of a 128 x 128 tile to the wgmma's 96 KB, for ~1,536 clocks
// of products.  From L2 each stage reads ~33 KB, ~21 B a clock an SM.
//
// What the design does about it:
//
// * One block a 128 x 128 tile of c: two consumer warpgroups of 64 rows
//   each and a producer warpgroup, whose registers go to the consumers
//   (setmaxnreg).  The producer keeps a ring of 4 stages in flight with
//   TMA: a's 128 x 32 slab (row-major, 128-byte swizzled) and b's
//   32 x 132 slab (unswizzled, 4 columns past the tile so that
//   neighbouring rows start 4 banks apart), rows and columns past the edges
//   filled with zeros.  The operands are read in place (a squaring reads
//   one tensor through two maps); the wrapper copies an a that is not
//   row-major (Y^T of a Y^T Y) once.
// * a is wgmma's register operand: each thread reads its fragments from the
//   slab and splits them in registers.  The 32 positions of a stage are
//   taken in an order (b's tiles share it) that gives each thread a 32-B
//   run of each of its rows, two 16-B loads a row.
// * b is the shared-memory operand, which wgmma at TF32 reads K-major: the
//   consumers split each slab into hi and lo tiles [128][32], 128-byte
//   swizzled, transposing it on the way, double-buffered so that the next
//   slab's split overlaps this one's products.  The two warpgroups meet
//   only at mbarriers (the split written, the products done), so one adds
//   its sums while the other's products run.  No hi or lo copy of an
//   operand reaches device memory.
// * The tensor cores' sums truncate, so a long chain of products into one
//   accumulator drifts: three passes chained over k = 4608 read 4.5x the f32
//   product's error, in k-chunks of 384 0.77x.  Each 32 positions of k run
//   their 12 wgmma (lo*hi, hi*lo, hi*hi of four k8 steps) into a fresh
//   accumulator, started with scale-d = 0, which is then added to the f32
//   sum in registers: 0.27x the f32 product's error at 4608^3.
// * The output is written once, two adjacent columns a store.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// rows and columns of a tile, positions of k a stage (one fresh
// accumulator's), stages
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kStages = 4;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;
// registers a thread: the producer warpgroup's few, the consumers' many
// (4 x 32 x 40 + 8 x 32 x 232 = 64,512 of the SM's 65,536)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// shared memory: hi and lo tiles of b, two buffers: [2][2][kBN][kBK]; a's
// slabs: [kStages][kBM][kBK]; b's slabs: [kStages][kBK][kPitch] (4 columns
// past the tile, so that rows 1 apart start 4 banks apart); the barriers
constexpr int kPitch = kBN + 4;
constexpr int kHL = kBN * kBK, kA = kBM * kBK, kB = kBK * kPitch;
constexpr size_t kSmemBytes =
    1024 + (4 * kHL + kStages * (kA + kB)) * sizeof(float) + (2 * kStages + 4) * sizeof(uint64_t);
constexpr uint32_t kTx = (kA + kB) * sizeof(float);
// one (kq, 4 columns n) item of b's split a consumer thread
static_assert(2 * kBN == kConsumers, "b's split gives each consumer one item");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// the spin stays inside the asm (its labels local to the block), so the
// compiler sees no divergent branch near the in-flight wgmma
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra.uni WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// a box of the 3-D tensor map `map` at (c0, c1, c2) into shared memory
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the consumers' shared-memory writes made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads of `x` across the wgmma wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&x)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// hi: x rounded to TF32, to nearest (ties away from zero); lo = x - hi, exact
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// The descriptor of a K-major, 128-byte swizzled tile of rows of 32 floats
// (8-row groups 1024 B apart; the leading offset unused), at 1024-B
// alignment.  Step j of 8 positions starts 32 B further (+2 in 16-B units).
__device__ __forceinline__ uint64_t tile_desc(const float* tile) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3FFFFull) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}


// Computes one 128 x 128 tile of c[z] (row pitch N, batch pitch sc_b).
// a's map: dims K, M, batch; box 32 x 128.  b's map: dims N, K, batch; box
// 132 x 32.
__global__ void __launch_bounds__(kThreads, 1)
    three_pass_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b, float* c, int M, int N, int K,
                      long long sc_b) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 1024-B aligned for the swizzle, indexed from the array itself so that
  // the compiler keeps shared-memory loads and stores (not generic ones)
  float* hl = reinterpret_cast<float*>(smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  float* slab_a = hl + 4 * kHL;
  float* slab_b = slab_a + kStages * kA;
  uint64_t* full = reinterpret_cast<uint64_t*>(slab_b + kStages * kB);
  uint64_t* empty = full + kStages;
  // per hi/lo buffer: its split written by all consumers; its products done
  uint64_t* split_done = empty + kStages;
  uint64_t* hl_free = split_done + 2;

  const int tid = threadIdx.x;
  // the warpgroup, provably uniform across each warp (0, 1: consumers)
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, z = blockIdx.z;
  const int steps = (K + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    for (int x = 0; x < 2; ++x) {
      mbar_init(split_done + x, kConsumers);
      mbar_init(hl_free + x, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (role == 2) {  // the producer warpgroup: one thread issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      for (int s = 0; s < steps; ++s) {
        const int slot = s % kStages;
        if (s >= kStages) mbar_wait(empty + slot, ((s / kStages) & 1) ^ 1);
        mbar_expect_tx(full + slot, kTx);
        tma_load(slab_a + slot * kA, &map_a, full + slot, s * kBK, m0, z);
        tma_load(slab_b + slot * kB, &map_b, full + slot, n0, s * kBK, z);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = role, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // the tile rows of this thread's fragment rows g (h = 0) and g + 8 (h = 1):
  // the warp's 16 rows in order (the slab's swizzle spreads them over the
  // banks).  The output rows follow the fragment rows.
  const int row[2] = {wg * 64 + warp * 16 + g, wg * 64 + warp * 16 + 8 + g};
  // a's fragments of slab s, split: [k8 step j][register: (row g, column
  // t), (g + 8, t), (g, t + 4), (g + 8, t + 4)].  The sum runs over a stage's
  // 32 k in any order that b's tiles share: column c of step j takes
  // k = 8 (c % 4) + 2j + c / 4, so that a thread's eight columns are the
  // 32-B run 8t..8t+7 of its rows, two 16-B loads a row (row r at r * 32
  // floats, its 16-B chunks swizzled by r % 8).
  auto load_a = [&](int s, uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
    const float* sa = slab_a + (s % kStages) * kA;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row[h];
      const float4 v0 = *reinterpret_cast<const float4*>(sa + r * 32 + (((2 * t) ^ (r & 7)) << 2));
      const float4 v1 =
          *reinterpret_cast<const float4*>(sa + r * 32 + (((2 * t + 1) ^ (r & 7)) << 2));
      split(v0.x, ah[0][h], al[0][h]);
      split(v0.y, ah[0][h + 2], al[0][h + 2]);
      split(v0.z, ah[1][h], al[1][h]);
      split(v0.w, ah[1][h + 2], al[1][h + 2]);
      split(v1.x, ah[2][h], al[2][h]);
      split(v1.y, ah[2][h + 2], al[2][h + 2]);
      split(v1.z, ah[3][h], al[3][h]);
      split(v1.w, ah[3][h + 2], al[3][h + 2]);
    }
  };

  // b's slab s split into hi and lo tiles [128][32], K-major, swizzled, in
  // the k order of a's fragments.  A thread takes 4 k (kq + 8e, positions
  // 4kq + e) by 4 n: 16-B reads of rows 1 apart and writes of one row's
  // chunks, each conflict-free.
  auto split_b = [&](int s) {
    const float* src = slab_b + (s % kStages) * kB;
    float* hi = hl + (s & 1) * 2 * kHL;
    float* lo = hi + kHL;
    const int kq = tid & 7, nb = 4 * (tid >> 3);
    float v[4][4];  // [e][c]: k = kq + 8e, n = nb + c
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 x = *reinterpret_cast<const float4*>(src + (kq + 8 * e) * kPitch + nb);
      v[e][0] = x.x, v[e][1] = x.y, v[e][2] = x.z, v[e][3] = x.w;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = nb + c;
      uint4 h4, l4;
      split(v[0][c], h4.x, l4.x);
      split(v[1][c], h4.y, l4.y);
      split(v[2][c], h4.z, l4.z);
      split(v[3][c], h4.w, l4.w);
      const int o = n * kBK + ((kq ^ (n & 7)) << 2);
      *reinterpret_cast<uint4*>(hi + o) = h4;
      *reinterpret_cast<uint4*>(lo + o) = l4;
    }
    fence_async_shared();
  };

  float sum[kBN / 2], acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) sum[i] = acc[i] = 0.f;

  // slab s of k: its products, with slab s + 1's split and fragments
  // (into the other fragment registers) made while they run.  The two
  // warpgroups meet only at mbarriers: one may add its sums while the
  // other's products run.
  using Frags = uint32_t[4][4];
  auto stage = [&](int s, const Frags& ah, const Frags& al, Frags& ah_next, Frags& al_next) {
    const int x = s & 1;
    mbar_wait(split_done + x, (s >> 1) & 1);  // b's hi and lo tiles of slab s written
    const float* hi = hl + x * 2 * kHL;
    const uint64_t d_hi = tile_desc(hi), d_lo = tile_desc(hi + kHL);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_tf32(acc, al[j], d_hi + 2 * j, j > 0);
      wgmma_tf32(acc, ah[j], d_lo + 2 * j, 1);
      wgmma_tf32(acc, ah[j], d_hi + 2 * j, 1);
    }
    wgmma_commit();
    if (s + 1 < steps) {
      mbar_wait(full + (s + 1) % kStages, ((s + 1) / kStages) & 1);
      // the other buffer's last products (slab s - 1) done in both warpgroups
      if (s > 0) mbar_wait(hl_free + (x ^ 1), ((s - 1) >> 1) & 1);
      split_b(s + 1);
      mbar_arrive(split_done + (x ^ 1));
      load_a(s + 1, ah_next, al_next);
      mbar_arrive(empty + (s + 1) % kStages);  // slab s + 1 read
    }
    wgmma_wait_all();
    mbar_arrive(hl_free + x);
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sum[i] += acc[i];
  };

  Frags ah0, al0, ah1, al1;
  mbar_wait(full, 0);
  split_b(0);
  mbar_arrive(split_done);
  load_a(0, ah0, al0);
  mbar_arrive(empty);
  for (int s = 0; s < steps; s += 2) {
    stage(s, ah0, al0, ah1, al1);
    if (s + 1 < steps) stage(s + 1, ah1, al1, ah0, al0);
  }

  // accumulator (h, j): rows g + 8h, columns 8j + 2t and 8j + 2t + 1
  float* cz = c + z * sc_b;
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + row[h];
    if (m >= M) continue;
    float* cm = cz + static_cast<long long>(m) * N;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      const float x0 = sum[4 * j + 2 * h], x1 = sum[4 * j + 2 * h + 1];
      if (pairs && n + 1 < N) {
        *reinterpret_cast<float2*>(cm + n) = make_float2(x0, x1);
      } else {
        if (n < N) cm[n] = x0;
        if (n + 1 < N) cm[n + 1] = x1;
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the runtime's entry-point query
// (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A 3-D map of f32 `base` (dims inner first; byte pitches of dims 1 and 2),
// boxes of box0 x box1 x 1, zeros outside.
int make_map(CUtensorMap* map, const float* base, long long d0, long long d1, long long d2,
             long long pitch1, long long pitch2, int box0, int box1, bool swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t pitches[2] = {static_cast<cuuint64_t>(pitch1), static_cast<cuuint64_t>(pitch2)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box0), static_cast<cuuint32_t>(box1), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims,
                            pitches, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  // a refused map: its CUresult, kept apart from the runtime's codes
  return r == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(r);
}

}  // namespace

// Raises the kernel's shared-memory limit on the current device; once per
// device, before the first launch and outside any capture.
extern "C" int vivit_three_pass_prepare() {
  return static_cast<int>(cudaFuncSetAttribute(
      three_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes));
}

// c [batch, M, N] (contiguous) = a [batch, M, K] @ b [batch, K, N], three
// TF32 passes, element strides given.  a is K-major (sa_k == 1), b N-major
// (sb_n == 1); the other strides are multiples of 4 and the bases 16-byte
// aligned (TMA's rules).  Launches on `stream` and returns
// cudaGetLastError() of the launch, or 10000 + the CUresult where a tensor
// map is refused.
extern "C" int vivit_three_pass_f32(const float* a, const float* b, float* c, int batch, int M,
                                    int N, int K, long long sa_b, long long sa_m, long long sa_k,
                                    long long sb_b, long long sb_k, long long sb_n, void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0 || K <= 0 || batch > 65535 || sa_k != 1 || sb_n != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap ma, mb;
  const long long fb = sizeof(float);
  // a lone batch gets a pitch past its matrix, which TMA never steps
  const long long pa_b = batch > 1 ? sa_b : sa_m * M;
  const long long pb_b = batch > 1 ? sb_b : sb_k * K;
  int err = make_map(&ma, a, K, M, batch, sa_m * fb, pa_b * fb, kBK, kBM, true);
  if (!err) err = make_map(&mb, b, N, K, batch, sb_k * fb, pb_b * fb, kPitch, kBK, false);
  if (err) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  three_pass_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      ma, mb, c, M, N, K, static_cast<long long>(M) * N);
  return static_cast<int>(cudaGetLastError());
}
