// PSS matched-filter correlation magnitude, and the same with each tile
// reduced to (max, first argmax, sum) per root, in two arithmetics.
//
// Replaces two TPU Pallas kernels of lteax/kernels/pss.py:
//   pss_corr_mag_pallas  -> lteax_pss_corr_bf16, lteax_pss_corr
//   pss_detect_pallas    -> lteax_pss_detect_bf16, lteax_pss_detect
// for its mdtype "bf16" (the reference's production default) and "f32" (its
// exactness-study mode).  Both compute, for the 3 PSS roots at once,
//
//   corr[n] = sum_{k=0}^{nf-1} x[n+k] * conj(h[k]),   |corr[n]|^2.
//
// What bounds it on an H100: operations.  At 20 MHz (nf = 2048) an output
// sample costs 49k flop against 8 bytes of IQ read, far above the memory
// roofline either way, so both routines keep the tile on chip and the detect
// entries never write the (C, 3, L) magnitudes at all.  On the tensor cores
// a bf16 pass costs 8 flop a (output, root, tap) at 989 TFLOP/s; the f32
// routine makes six such passes (below), so its bound is six times the bf16
// one (0.733 ms at 4 x 614 400 samples and 2048 taps, against 1.80 ms for
// an f32 correlator on the CUDA cores with every multiply-add fused).
//
// One kernel body, pss_gemm_kernel<DETECT, PLANES>, runs both as a Toeplitz
// GEMM on the tensor cores.  Frames of 64 samples are GEMM rows; a tile of
// T frames x 64 outputs is sum_c X[c : c+T, :] * G_c over the nf/64 + 1
// chunk matrices G_c[s, i] = conj(h[64 c + s - i]).  The complex product is
// one real GEMM: A = the frame's (re, im) pairs as they lie in memory
// (K = 128), B = [[gr, gi], [-gi, gr]] in the same interleaving (N = 128 per
// root), so a thread's accumulator holds (re, im) of an output side by side.
// A block takes one carrier, one root and 256 frames: the A slab is staged
// in the no-swizzle core-matrix layout, in which the shifted operand
// X[c : c+T] is the same slab at a 16-byte row offset (no im2col copy); the
// B chunks (32 KB each, 3 MB a plane at 20 MHz, L2-resident) stream through
// a 4-stage cp.async ring already in their shared-memory image; two
// warpgroups issue wgmma m64n128k16 with 128 x 128 f32 accumulators each.
// The Toeplitz form does (nf + 64)/nf = 1.03 of the useful work.  The
// prologue (staging A) and the epilogue are not overlapped (one block an SM).
//
// PLANES = 1, the bf16 routine, does what the TPU kernel does: x and the
// replicas rounded to bf16, exact products, f32 accumulation, one pass over
// the chunks.  Measured with the loads or the wgmmas taken out, the wgmmas
// are the longer part and the loads hide behind them.
//
// PLANES = 3, the f32 routine, splits both operands into three bf16 planes,
// v = v0 + v1 + v2 with v0 = bf16(v), v1 = bf16(v - v0), v2 = bf16(v - v0 -
// v1) (both subtractions exact in f32; the sum is v itself for every f32
// value of magnitude 2^-110 or more, far below any IQ sample that moves a
// correlation).  x is split while its slab is staged, the replicas' operand
// on the host (lteax_torch/kernels/pss.py::_toeplitz_planes).  The product
// keeps the six plane products X_i B_j with i + j <= 2 (PSS_F32_PASSES
// below); the three left out are of order 2^-24 of a product.  The slab
// holds one A plane (three and the ring would pass the 227 KB a block may
// use), so the passes are grouped by A plane: stage x0, sweep the chunks with
// B0, B1, B2; stage x1, sweep with B0, B1; stage x2, sweep with B0 -- six
// sweeps in one ordered list through the same ring, the accumulators in
// registers throughout.  The tensor cores round each accumulation toward
// zero, so 6 x 264 accumulations into one register would lose ~1e-4 of the
// peak, one-sided; instead each warpgroup sums a chunk's eight k-steps into
// fresh registers and adds them to its accumulators in f32 (round to
// nearest), which keeps the sum at the f32 level.
//
// Both routines sum in another order than their plain torch versions, so
// each is held to its plain version by a tolerance (pss.py's BF16_TOL and
// F32_TOL), and exactly in root and peak index.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// (A plane, B plane) of each pass of the f32 routine, grouped by A plane
// (the tests parse this table back and emulate it).
#define PSS_F32_PASSES {{0, 0}, {0, 1}, {0, 2}, {1, 0}, {1, 1}, {2, 0}}

namespace {

constexpr int kF32Passes = 6;
constexpr int kPassHost[kF32Passes][2] = PSS_F32_PASSES;
__constant__ int kPass[kF32Passes][2] = PSS_F32_PASSES;

// What the kernel relies on: every product with i + j <= 2 exactly once,
// and the passes of one A plane together (the slab is staged once a plane).
constexpr bool passes_are_the_split() {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; i + j < 3; ++j) {
      int n = 0;
      for (int p = 0; p < kF32Passes; ++p)
        n += kPassHost[p][0] == i && kPassHost[p][1] == j;
      if (n != 1) return false;
    }
  for (int p = 1; p < kF32Passes; ++p)
    if (kPassHost[p][0] < kPassHost[p - 1][0]) return false;
  return kPassHost[0][0] == 0;
}
static_assert(passes_are_the_split(),
              "the f32 routine needs the six plane products with i + j <= 2, "
              "grouped by A plane");

constexpr int kFrame = 64;               // samples per GEMM row
constexpr int kRows = 256;               // frames (GEMM rows) per block
constexpr int kK = 2 * kFrame;           // K of one chunk: (re, im) interleaved
constexpr int kN = 2 * kFrame;           // N of one root: (re, im) interleaved
constexpr int kGemmThreads = 256;        // two warpgroups, 128 rows each
constexpr int kStages = 4;               // ring of B chunks
constexpr int kChunkBytes = kK * kN * 2; // one chunk of one root, bf16

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Shared-memory matrix descriptor, no swizzle, K-major: core matrices of
// 8 rows x 16 bytes; `lbo` bytes between core matrices along K, `sbo` bytes
// between 8-row groups along M or N.
__device__ __forceinline__ unsigned long long smem_desc(unsigned addr,
                                                        unsigned lbo,
                                                        unsigned sbo) {
  return (unsigned long long)((addr & 0x3FFFFu) >> 4) |
         ((unsigned long long)(lbo >> 4) << 16) |
         ((unsigned long long)(sbo >> 4) << 32);
}

// D (64 x 128, f32, in registers) = scale_d * D + A (64 x 16, shared) *
// B (16 x 128, shared), both bf16 and K-major; scale_d is 0 or 1.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 unsigned long long da,
                                                 unsigned long long db,
                                                 int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

// Rows of the A slab: the block's frames and the nc halo frames, made odd
// (16-byte rows an odd count apart fall into different banks when the slab
// is written).
__host__ __device__ inline int slab_rows(int nc) { return (kRows + nc) | 1; }

__device__ __forceinline__ float bf16_rn(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Plane `plane` of the three-plane split of v: v0 = bf16(v), v1 = bf16(v -
// v0), v2 = bf16(v - v0 - v1), each subtraction exact in f32.  Plane 0 is
// the bf16 routine's rounding of v.
__device__ __forceinline__ float plane_rest(float v, int plane) {
  for (int p = 0; p < plane; ++p) v = v - bf16_rn(v);
  return v;                       // plane `plane` is bf16_rn of this
}

// A block owns one carrier, one root and kRows frames of kFrame outputs.
//   A: the frames as GEMM rows, K = 128 interleaved (re, im) values of a
//      frame's 64 samples, one bf16 plane of them laid out as 16 K-groups of
//      16-byte rows: X[c : c + 64] for chunk c is the same slab read c rows
//      further down, no copy.
//   B: per plane, chunk and root the 128 x 128 matrix [[gr, gi], [-gi, gr]]
//      in the same interleaving, streamed from device memory (resident in
//      L2) through a ring of cp.async stages, already in its shared-memory
//      image.
//   D: each warpgroup accumulates 128 rows x 128 columns in registers over
//      all passes and chunks; a thread holds (re, im) of an output in
//      neighbouring registers, so |.|^2 needs no exchange.
// PLANES = 1 makes one pass (x0, B0); PLANES = 3 the kF32Passes of kPass.
template <bool DETECT, int PLANES>
__global__ void __launch_bounds__(kGemmThreads, 1)
pss_gemm_kernel(const float* __restrict__ x,
                const unsigned char* __restrict__ b, float* __restrict__ out,
                float* __restrict__ maxv, int* __restrict__ argv,
                float* __restrict__ sumv, int l, int nch, int n_tiles) {
  static_assert(PLANES == 1 || PLANES == 3, "one plane (bf16) or three (f32)");
  constexpr int kPasses = PLANES == 1 ? 1 : kF32Passes;
  extern __shared__ __align__(128) unsigned char gsm[];
  const int tile = blockIdx.x % n_tiles;
  const int root = (blockIdx.x / n_tiles) % 3;
  const int c = blockIdx.x / (3 * n_tiles);
  const int rows = slab_rows(nch - 1);
  const unsigned lbo_a = rows * 16;
  unsigned char* slab = gsm;                           // 16 x rows x 16 B
  const unsigned slab_s = smem_addr(slab);
  const unsigned ring_s = slab_s + 16 * lbo_a;         // kStages chunks
  const int n_steps = kPasses * nch;                   // (pass, chunk) pairs
  auto a_plane = [&](int pass) { return PLANES == 1 ? 0 : kPass[pass][0]; };

  // step q = (pass q / nch, chunk q % nch) of this root into its stage, 16
  // bytes a thread and step
  const unsigned char* bsrc = b + (size_t)root * kChunkBytes;
  auto load_chunk = [&](int q) {
    if (q < n_steps) {
      const int pass = PLANES == 1 ? 0 : q / nch;
      const int bp = PLANES == 1 ? 0 : kPass[pass][1];
      const unsigned char* src =
          bsrc + ((size_t)bp * nch + q - pass * nch) * 3 * kChunkBytes;
      const unsigned dst = ring_s + (q % kStages) * kChunkBytes;
      for (int i = threadIdx.x * 16; i < kChunkBytes; i += kGemmThreads * 16)
        cp_async16(dst + i, src + i);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  for (int q = 0; q < kStages - 1; ++q) load_chunk(q);

  // A slab: 8 floats (4 samples) -> 8 bf16 = one 16-byte row of a K-group
  const long long f0 = (long long)tile * kRows * kK;   // first float of tile
  const float* xc = x + (long long)c * l * 2;
  const long long lim = (long long)l * 2;
  auto stage_a = [&](int plane) {
    for (int i = threadIdx.x; i < (kRows + nch - 1) * 16; i += kGemmThreads) {
      const int row = i >> 4, grp = i & 15;
      const long long f = f0 + (long long)row * kK + grp * 8;
      float v[8];
      if (f + 8 <= lim) {
        // 8-byte loads: a carrier's row starts at an even float, no more
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 p = *reinterpret_cast<const float2*>(xc + f + 2 * e);
          v[2 * e] = p.x;
          v[2 * e + 1] = p.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = f + e < lim ? xc[f + e] : 0.0f;
      }
      if (PLANES > 1) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = plane_rest(v[e], plane);
      }
      __nv_bfloat162 pk[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pk[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      *reinterpret_cast<uint4*>(slab + (size_t)grp * lbo_a + row * 16) =
          *reinterpret_cast<const uint4*>(pk);
    }
  };
  stage_a(0);

  const int wg = threadIdx.x >> 7;                     // warpgroup
  float acc[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.0f;
  float part[64];              // PLANES = 3: a chunk's k-steps, then to acc
  if constexpr (PLANES > 1) {
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = 0.0f;
  }

  int pass = 0, kc = 0;         // PLANES = 3: step q's pass and chunk
  for (int q = 0; q < n_steps; ++q) {
    const int k = PLANES == 1 ? q : kc;
    if (PLANES > 1 && k == 0 && pass > 0 &&
        a_plane(pass) != a_plane(pass - 1)) {
      __syncthreads();         // both warpgroups are done with the old plane
      stage_a(a_plane(pass));
    }
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    // this thread's copies and slab stores, before the async proxy reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::);
    __syncthreads();           // step q is whole; stage (q-1) % kStages free
    load_chunk(q + kStages - 1);
    const unsigned bs = ring_s + (q % kStages) * kChunkBytes;
    if constexpr (PLANES == 1) {
      asm volatile("wgmma.fence.sync.aligned;\n" ::);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned as = slab_s + (k + wg * 128 + h * 64) * 16;
#pragma unroll
        for (int kk = 0; kk < kK / 16; ++kk)
          wgmma_m64n128k16(acc[h],
                           smem_desc(as + kk * 2 * lbo_a, lbo_a, 128),
                           smem_desc(bs + kk * 2 * (kN * 16), kN * 16, 128));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned as = slab_s + (k + wg * 128 + h * 64) * 16;
        asm volatile("wgmma.fence.sync.aligned;\n" ::);
#pragma unroll
        for (int kk = 0; kk < kK / 16; ++kk)
          wgmma_m64n128k16(part, smem_desc(as + kk * 2 * lbo_a, lbo_a, 128),
                           smem_desc(bs + kk * 2 * (kN * 16), kN * 16, 128),
                           kk > 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::);
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[h][i] = acc[h][i] + part[i];
      }
    }
    if (PLANES > 1 && ++kc == nch) {
      kc = 0;
      ++pass;
    }
  }

  // a thread's accumulators: rows r0 and r0 + 8 of each 64-row half, and of
  // each 8-column group the output i = 4 * group + lane % 4 as (re, im)
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r0 = wg * 128 + warp * 16 + (lane >> 2);
  const long long n0 = (long long)tile * kRows * kFrame;
  float s = 0.0f, best = -1.0f;
  int bi = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int up = 0; up < 2; ++up) {
      const int row = r0 + h * 64 + up * 8;
      const long long nrow = n0 + (long long)row * kFrame;
#pragma unroll
      for (int g = 0; g < 16; ++g) {
        const float re = acc[h][4 * g + 2 * up];
        const float im = acc[h][4 * g + 2 * up + 1];
        const float m = re * re + im * im;
        const int i = 4 * g + (lane & 3);
        if (DETECT) {
          s = s + m;
          if (m > best) {        // positions rise along this loop nest
            best = m;
            bi = row * kFrame + i;
          }
        } else if (nrow + i < l) {
          out[((long long)c * 3 + root) * l + nrow + i] = m;
        }
      }
    }
  if (!DETECT) return;

  // the tile's (max, first argmax, sum): warps fold by shuffles, then the
  // eight warp results in order
  __shared__ float ws[kGemmThreads / 32];
  __shared__ float wb[kGemmThreads / 32];
  __shared__ int wi[kGemmThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s = s + __shfl_down_sync(0xffffffffu, s, off);
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (ob > best || (ob == best && oi < bi)) {
      best = ob;
      bi = oi;
    }
  }
  if (lane == 0) {
    ws[threadIdx.x >> 5] = s;
    wb[threadIdx.x >> 5] = best;
    wi[threadIdx.x >> 5] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kGemmThreads / 32; ++w) {
      s = s + ws[w];
      if (wb[w] > best || (wb[w] == best && wi[w] < bi)) {
        best = wb[w];
        bi = wi[w];
      }
    }
    const long long o = ((long long)c * 3 + root) * n_tiles + tile;
    maxv[o] = best;
    argv[o] = bi;
    sumv[o] = s;
  }
}

template <bool DETECT, int PLANES>
int launch_gemm(const float* x, const void* b, float* out, float* maxv,
                int* argv, float* sumv, int c, int l, int nf,
                cudaStream_t stream) {
  const int tile_len = kRows * kFrame;
  const int n_tiles = (l + tile_len - 1) / tile_len;
  if (c <= 0 || n_tiles <= 0) return 0;
  const int nch = (nf + kFrame - 1) / kFrame + 1;
  const long long blocks = (long long)c * 3 * n_tiles;
  if (nf <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)16 * slab_rows(nch - 1) * 16 + (size_t)kStages * kChunkBytes;
  cudaError_t e = cudaFuncSetAttribute(
      pss_gemm_kernel<DETECT, PLANES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  pss_gemm_kernel<DETECT, PLANES>
      <<<(unsigned)blocks, kGemmThreads, smem, stream>>>(
          x, static_cast<const unsigned char*>(b), out, maxv, argv, sumv, l,
          nch, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (C, L) complex as interleaved f32 pairs; b: the Toeplitz operand,
// bf16 (planes, nf/64 + 1, 3, 16, 128, 8) (lteax_torch/kernels/pss.py::
// _operand): one plane of the bf16-rounded replicas for the bf16 routine,
// the three planes of the replicas for the f32 one; out: (C, 3, L) f32.
// Each returns cudaGetLastError().

// The f32 routine: |corr|^2 over the three-plane split.
extern "C" int lteax_pss_corr(const float* x, const void* b, float* out,
                              int c, int l, int nf, cudaStream_t stream) {
  return launch_gemm<false, 3>(x, b, out, nullptr, nullptr, nullptr, c, l,
                               nf, stream);
}

// As lteax_pss_corr, but writes per-tile partials (C, 3, n_tiles) of tiles
// of 256 * 64 outputs instead: maxv f32, argv i32 (index within the tile,
// first maximum), sumv f32.
extern "C" int lteax_pss_detect(const float* x, const void* b, float* maxv,
                                int* argv, float* sumv, int c, int l, int nf,
                                cudaStream_t stream) {
  return launch_gemm<true, 3>(x, b, nullptr, maxv, argv, sumv, c, l, nf,
                              stream);
}

// The bf16 routine, as lteax_pss_corr.
extern "C" int lteax_pss_corr_bf16(const float* x, const void* b, float* out,
                                   int c, int l, int nf, cudaStream_t stream) {
  return launch_gemm<false, 1>(x, b, out, nullptr, nullptr, nullptr, c, l,
                               nf, stream);
}

// The bf16 routine, as lteax_pss_detect.
extern "C" int lteax_pss_detect_bf16(const float* x, const void* b,
                                     float* maxv, int* argv, float* sumv,
                                     int c, int l, int nf,
                                     cudaStream_t stream) {
  return launch_gemm<true, 1>(x, b, nullptr, maxv, argv, sumv, c, l, nf,
                              stream);
}
