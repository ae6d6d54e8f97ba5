// The columns of a token block's V^T, three TF32 passes on the tensor cores:
// out[c*S + n, o, i] = sum_p delta[c, n, p, o] * z[n, p, i] over the T
// positions, one f32 chunk of rows o of the weight and columns i at a time.
//
// Stands for no Pallas kernel: the JAX package has no token factor (it runs
// the structured entries at "highest", in f32).  It replaces the f32 batched
// product of TokenFactor.expand (torch.bmm over CF copies of z), which runs
// on the SIMT units.  It computes the function of the plain version
// kernels/token_expand.py:token_expand_plain: each factor split into hi, its
// TF32 rounding to nearest (the low 13 mantissa bits rounded off, as
// precision.tf32_split), and the exact lo = x - hi; lo*hi + hi*lo + hi*hi
// summed in f32.  The tensor cores multiply hi exactly and lo cut to TF32,
// and lo*lo lies below an f32 product's error.
//
// What bounds it on an H100: at ViT-S/16 (N=128, CF=9, T=197) a query's 48
// token blocks take 28.9 TFLOP as three TF32 passes, 58.4 ms at 495 TFLOP/s
// (mma.sync reaches ~300 TFLOP/s of TF32 on this card, 96 ms), and move 136
// GB (98 GB of f32 columns written), 40.5 ms at 3.35 TB/s.  The sum is short
// (T = 197), so a block's pipeline fills and drains often, and a tiling that
// streams both factors reads each of them from L2 once for every tile of the
// other: 4.7 GB for one 1 GiB chunk of qkv in 128 x 64 tiles.
//
// What the design does about it:
//
// * One block a column (c, n) and a range of 192 or 128 of its columns
//   i.  It holds z[n, :, i-range] in shared memory for its whole life (read
//   from L2 once) and streams delta[c, n] through a ring of two tiles of 64
//   positions by 64 or 128 rows o (cp.async, 16 bytes a copy where the
//   widths and strides allow, else 4; rows past T and columns past the
//   chunk filled with zeros), one o-tile after the other, so that each of
//   delta's bytes crosses L2 once per i-range.  delta and z are read in
//   place: no copies of z, no transposed delta.  Rows of shared memory are
//   padded by 8 words, so that the fragment loads below hit 32 banks.
// * mma.sync m16n8k8 at TF32 (8 or 16 warps, 2 or 4 along o by 4 along
//   i; 16 where the registers allow, at 128 columns): each warp
//   loads its fragments as they lie in shared memory and splits them in
//   registers, so that only the raw factors pass through shared memory.
// * The tensor cores' sums truncate, so a long chain of products into one
//   accumulator drifts (5.7x the f32 product's error at T = 197 in one
//   chain, 1.8x in chains of 64 positions).  Each 32 positions sum their
//   three passes into a fresh accumulator, which is then added to the f32
//   sum in registers (rounded to nearest): a chain is 12 products long, and
//   the columns read 1.0x the f32 product's error.
// * The ring runs on across o-tiles, so that the next tile's loads overlap
//   the write of the last one; each o-tile is written once (two adjacent
//   columns a store).  Where T rows of z do not fit shared memory, the
//   wrapper launches once per range of positions, each launch after the
//   first adding to the chunk.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// positions a tile of delta's ring holds, the tiles in the ring, and the
// positions whose three passes one fresh accumulator sums
constexpr int kBK = 64;
constexpr int kStages = 2;
constexpr int kPromote = 32;
// a block's most dynamic shared memory on an H100
constexpr int kMaxShared = 232448;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

// hi: x rounded to TF32, to nearest (ties away from zero); lo = x - hi, exact
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Args {
  const float* d;  // delta's rows k0.. of the chunk: [CF, S, T, oc] (strides below)
  const float* z;  // z's rows k0.. of the chunk: [S, T, ic]
  float* out;      // [CF*S, oc, ic], contiguous
  int S, T, OC, IC, ranges, accumulate;
  long long sd_c, sd_n, sd_p, sd_o, sz_n, sz_p, sz_i;
};

// A block of WO x 4 warps: WO along o (32 rows, two m16 tiles each), 4 along
// i (WN n8 tiles each), so BO = 32 WO rows of delta a tile and BI = 32 WN
// columns of z.  Each row of shared memory is padded by 8 words.
template <int WN, int WO>
struct Shape {
  static constexpr int BI = 4 * WN * 8, BO = WO * 32, kThreads = WO * 4 * 32;
  static constexpr int LDZ = BI + 8, LDO = BO + 8, kRing = kStages * kBK * LDO;
  // the most rows of z, a multiple of 8, that fit beside the ring
  static constexpr int kMaxRows = (kMaxShared / 4 - kRing) / LDZ / 8 * 8;
  static size_t bytes(int t) {
    return (static_cast<size_t>((t + 7) / 8 * 8) * LDZ + kRing) * sizeof(float);
  }
};

template <int WN, int WO, bool VEC>
__global__ void __launch_bounds__(Shape<WN, WO>::kThreads) token_expand_kernel(Args a) {
  using L = Shape<WN, WO>;
  constexpr int BI = L::BI, BO = L::BO, LDZ = L::LDZ, LDO = L::LDO, NT = L::kThreads;
  extern __shared__ __align__(16) float smem[];
  const int t8 = (a.T + 7) / 8 * 8;
  float* zs = smem;             // z[n, :, i-range]: [t8][LDZ], zeros past T and IC
  float* ring = zs + t8 * LDZ;  // delta's tiles: [kStages][kBK][LDO]

  const int col = blockIdx.x / a.ranges, i_base = (blockIdx.x % a.ranges) * BI;
  const int c = col / a.S, n = col % a.S;
  const float* dcol = a.d + c * a.sd_c + n * a.sd_n;
  const float* zcol = a.z + n * a.sz_n;
  const int steps = (a.T + kBK - 1) / kBK;
  const int total = (a.OC + BO - 1) / BO * steps;

  // z's rows of the block, once
  if (VEC) {
    for (int v = threadIdx.x; v < t8 * (BI / 4); v += NT) {
      const int r = v / (BI / 4), x = (v % (BI / 4)) * 4;
      const bool ok = r < a.T && i_base + x < a.IC;
      cp_async16(zs + r * LDZ + x, ok ? zcol + r * a.sz_p + i_base + x : a.z, ok);
    }
  } else {
    for (int v = threadIdx.x; v < t8 * BI; v += NT) {
      const int r = v / BI, x = v % BI;
      const bool ok = r < a.T && i_base + x < a.IC;
      cp_async4(zs + r * LDZ + x, ok ? zcol + r * a.sz_p + (i_base + x) * a.sz_i : a.z, ok);
    }
  }
  // delta's tile j: positions (j % steps) * kBK.. of the o-tile j / steps
  auto load = [&](int j) {
    float* ds = ring + (j % kStages) * kBK * LDO;
    const int k0 = (j % steps) * kBK, o0 = (j / steps) * BO;
    if (VEC) {
      for (int v = threadIdx.x; v < kBK * BO / 4; v += NT) {
        const int r = v / (BO / 4), x = (v % (BO / 4)) * 4;
        const bool ok = k0 + r < a.T && o0 + x < a.OC;
        cp_async16(ds + r * LDO + x, ok ? dcol + (k0 + r) * a.sd_p + o0 + x : a.d, ok);
      }
    } else {
      for (int v = threadIdx.x; v < kBK * BO; v += NT) {
        const int r = v / BO, x = v % BO;
        const bool ok = k0 + r < a.T && o0 + x < a.OC;
        cp_async4(ds + r * LDO + x, ok ? dcol + (k0 + r) * a.sd_p + (o0 + x) * a.sd_o : a.d, ok);
      }
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wo = (warp / 4) * 32, wi = (warp % 4) * WN * 8;
  float* ocol = a.out + static_cast<long long>(col) * a.OC * a.IC;

  float acc[2][WN][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < WN; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // the first group holds z's rows too
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < total) load(j);
    cp_async_commit();
  }
  for (int j = 0; j < total; ++j) {
    cp_async_wait_ring();
    __syncthreads();  // tile j (and z) landed; the buffer refilled next is free
    if (j + kStages - 1 < total) load(j + kStages - 1);
    cp_async_commit();

    const float* ds = ring + (j % kStages) * kBK * LDO;
    const int k0 = (j % steps) * kBK;
#pragma unroll
    for (int kp = 0; kp < kBK; kp += kPromote) {
      float blk[2][WN][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < WN; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) blk[mi][ni][e] = 0.f;
#pragma unroll
      for (int kk = kp; kk < kp + kPromote; kk += 8) {
        if (k0 + kk >= t8) continue;  // rows past T: zeros
        // A = delta^T (rows o, columns p), B = z (rows p, columns i)
        uint32_t ah[2][4], al[2][4], bh[WN][2], bl[WN][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float* p0 = ds + (kk + t) * LDO + wo + mi * 16 + g;
          split(p0[0], ah[mi][0], al[mi][0]);
          split(p0[8], ah[mi][1], al[mi][1]);
          split(p0[4 * LDO], ah[mi][2], al[mi][2]);
          split(p0[4 * LDO + 8], ah[mi][3], al[mi][3]);
        }
#pragma unroll
        for (int ni = 0; ni < WN; ++ni) {
          const float* p0 = zs + (k0 + kk + t) * LDZ + wi + ni * 8 + g;
          split(p0[0], bh[ni][0], bl[ni][0]);
          split(p0[4 * LDZ], bh[ni][1], bl[ni][1]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < WN; ++ni) mma(blk[mi][ni], al[mi], bh[ni]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < WN; ++ni) mma(blk[mi][ni], ah[mi], bl[ni]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < WN; ++ni) mma(blk[mi][ni], ah[mi], bh[ni]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < WN; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += blk[mi][ni][e];
    }

    if (j % steps == steps - 1) {  // the o-tile's sum is whole: write it, start the next
      const int o0 = (j / steps) * BO;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < WN; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int o = o0 + wo + mi * 16 + g + 8 * h;
            const int i = i_base + wi + ni * 8 + 2 * t;
            float x0 = acc[mi][ni][2 * h], x1 = acc[mi][ni][2 * h + 1];
            acc[mi][ni][2 * h] = acc[mi][ni][2 * h + 1] = 0.f;
            if (o >= a.OC) continue;
            float* p = ocol + static_cast<long long>(o) * a.IC + i;
            if (VEC) {
              if (i >= a.IC) continue;
              float2* q = reinterpret_cast<float2*>(p);
              if (a.accumulate) {
                const float2 was = *q;
                x0 += was.x;
                x1 += was.y;
              }
              *q = make_float2(x0, x1);
            } else {
              if (i < a.IC) p[0] = a.accumulate ? p[0] + x0 : x0;
              if (i + 1 < a.IC) p[1] = a.accumulate ? p[1] + x1 : x1;
            }
          }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

template <int WN, int WO, bool VEC>
int prepare_one() {
  return static_cast<int>(cudaFuncSetAttribute(token_expand_kernel<WN, WO, VEC>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kMaxShared));
}

template <int WN, int WO>
int launch(const Args& a, int cols, bool vec, cudaStream_t stream) {
  using L = Shape<WN, WO>;
  if (a.T > L::kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(cols) * a.ranges;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto grid = static_cast<unsigned>(blocks);
  if (vec) {
    token_expand_kernel<WN, WO, true><<<grid, L::kThreads, L::bytes(a.T), stream>>>(a);
  } else {
    token_expand_kernel<WN, WO, false><<<grid, L::kThreads, L::bytes(a.T), stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Raises the kernels' shared-memory limit on the current device; once per
// device, before the first launch and outside any capture.
extern "C" int vivit_token_expand_prepare() {
  int err = prepare_one<6, 2, true>();
  if (!err) err = prepare_one<6, 2, false>();
  if (!err) err = prepare_one<4, 4, true>();
  if (!err) err = prepare_one<4, 4, false>();
  return err;
}

// The most rows of positions one launch with blocks `width` columns i wide
// takes (0 for a width the kernel does not have).
extern "C" int vivit_token_expand_max_rows(int width) {
  switch (width) {
    case 192: return Shape<6, 2>::kMaxRows;
    case 128: return Shape<4, 4>::kMaxRows;
    default: return 0;
  }
}

// The columns of delta [CF, S, T, oc] and z [S, T, ic] (element strides
// given; views of the chunk, from the first row of this launch's range of
// positions) into out [CF*S, oc, ic] (contiguous): written, or added to it
// where `accumulate`.  A block takes `width` columns i (192 or 128) of
// one column (c, n): ceil(ic / width) blocks a column; T is at most
// vivit_token_expand_max_rows(width).  `vec` selects the 16-byte copies,
// which need unit inner strides, oc, ic and the other strides multiples of
// 4 and 16-byte aligned pointers.  Launches on `stream` and returns
// cudaGetLastError() of the launch.
extern "C" int vivit_token_expand_f32(const float* d, const float* z, float* out, int cf, int S,
                                      int T, int OC, int IC, long long sd_c, long long sd_n,
                                      long long sd_p, long long sd_o, long long sz_n,
                                      long long sz_p, long long sz_i, int width, int accumulate,
                                      int vec, void* stream) {
  if (cf <= 0 || S <= 0 || T <= 0 || OC <= 0 || IC <= 0 || width <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{d, z, out, S, T, OC, IC, (IC + width - 1) / width, accumulate,
               sd_c, sd_n, sd_p, sd_o, sz_n, sz_p, sz_i};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 192: return launch<6, 2>(a, cf * S, vec, s);
    case 128: return launch<4, 4>(a, cf * S, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
