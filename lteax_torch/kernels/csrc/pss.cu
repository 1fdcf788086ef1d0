// PSS matched-filter correlation magnitude, and the same with each tile
// reduced to (max, first argmax, sum) per root.
//
// Replaces two TPU Pallas kernels of lteax/kernels/pss.py:
//   pss_corr_mag_pallas  -> lteax_pss_corr   (|corr|^2, (C, 3, L) f32)
//   pss_detect_pallas    -> lteax_pss_detect (per-tile partials only)
// Both run one device routine, pss_kernel<DETECT>.  The TPU kernels cut the
// length-nf filter into Toeplitz chunk matrices for the MXU (bf16 in, f32
// accumulation).  Here the correlator is direct, in the time domain:
//
//   corr[n] = sum_{k=0}^{nf-1} x[n+k] * conj(h[k]),   |corr[n]|^2,
//
// for the 3 PSS roots at once, k accumulated in order in f32 (the
// reference's mdtype="f32" numerics).  A block owns one carrier and one
// tile of kTile outputs: it stages x[t0, t0+kTile+nf) and the 3 replicas
// (3 x 2048 complex = 48 KB at 20 MHz) in shared memory; each thread owns
// kPer outputs kThreads apart (so a warp's x reads are consecutive) and
// all 3 roots, 24 accumulators in registers.
//
// What bounds it on an H100: FP32 issue.  Per output, root and tap it does
// 4 multiplies and 4 adds (no FMA: -fmad=false keeps every rounding the
// plain version makes), against 7 shared-memory loads per tap shared by
// the thread's 12 (output, root) pairs.  At 20 MHz that is 49k flops per
// output sample; reading 8 bytes of IQ per sample it is far above the
// memory roofline, so the tile stays on chip and the detect entry never
// writes the (C, 3, L) magnitudes at all.  Tensor cores (the TPU's
// Toeplitz-GEMM form in bf16) are later work.
//
// The detect entry reduces each tile per root: a thread sums its kPer
// magnitudes in order, a warp folds with shuffles (offsets 16..1), thread
// 0 adds the 8 warp sums in order; the max is exact and ties go to the
// smallest index.  The plain torch version (lteax_torch/kernels/pss.py)
// reduces in the same tree, so all outputs equal it bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;
constexpr int kTile = kThreads * kPer;   // outputs per block
constexpr int kWarps = kThreads / 32;

template <bool DETECT>
__global__ void __launch_bounds__(kThreads)
pss_kernel(const float2* __restrict__ x, const float2* __restrict__ h,
           float* __restrict__ out, float* __restrict__ maxv,
           int* __restrict__ argv, float* __restrict__ sumv, int l, int nf,
           int n_tiles) {
  extern __shared__ float2 smem[];
  float2* sh = smem;                  // 3 * nf replicas
  float2* sx = smem + 3 * nf;         // kTile + nf samples
  const int c = blockIdx.y;
  const int tile = blockIdx.x;
  const long long t0 = (long long)tile * kTile;
  const float2* xc = x + (long long)c * l;
  for (int i = threadIdx.x; i < 3 * nf; i += kThreads) sh[i] = h[i];
  for (int i = threadIdx.x; i < kTile + nf; i += kThreads) {
    const long long n = t0 + i;
    sx[i] = n < l ? xc[n] : make_float2(0.0f, 0.0f);
  }
  __syncthreads();

  float cr[kPer][3], ci[kPer][3];
#pragma unroll
  for (int j = 0; j < kPer; ++j)
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      cr[j][r] = 0.0f;
      ci[j][r] = 0.0f;
    }
#pragma unroll 2
  for (int k = 0; k < nf; ++k) {
    float2 hv[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) hv[r] = sh[r * nf + k];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float2 xv = sx[threadIdx.x + j * kThreads + k];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        float tr = xv.x * hv[r].x;
        tr = tr + xv.y * hv[r].y;          // Re(x conj h)
        float ti = xv.y * hv[r].x;
        ti = ti - xv.x * hv[r].y;          // Im(x conj h)
        cr[j][r] = cr[j][r] + tr;
        ci[j][r] = ci[j][r] + ti;
      }
    }
  }
  float m[kPer][3];
#pragma unroll
  for (int j = 0; j < kPer; ++j)
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      float v = cr[j][r] * cr[j][r];
      m[j][r] = v + ci[j][r] * ci[j][r];
    }

  if (!DETECT) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long n = t0 + threadIdx.x + j * kThreads;
      if (n < l) {
#pragma unroll
        for (int r = 0; r < 3; ++r) out[((long long)c * 3 + r) * l + n] = m[j][r];
      }
    }
    return;
  }

  __shared__ float ws[3][kWarps];
  __shared__ float wb[3][kWarps];
  __shared__ int wi[3][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float s = m[0][r];
    float best = m[0][r];
    int bi = threadIdx.x;
#pragma unroll
    for (int j = 1; j < kPer; ++j) {
      s = s + m[j][r];
      if (m[j][r] > best) {
        best = m[j][r];
        bi = threadIdx.x + j * kThreads;
      }
    }
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
      ws[r][warp] = s;
      wb[r][warp] = best;
      wi[r][warp] = bi;
    }
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    const int r = threadIdx.x;
    float s = ws[r][0];
    float best = wb[r][0];
    int bi = wi[r][0];
    for (int w = 1; w < kWarps; ++w) {
      s = s + ws[r][w];
      if (wb[r][w] > best || (wb[r][w] == best && wi[r][w] < bi)) {
        best = wb[r][w];
        bi = wi[r][w];
      }
    }
    const long long o = ((long long)c * 3 + r) * n_tiles + tile;
    maxv[o] = best;
    argv[o] = bi;
    sumv[o] = s;
  }
}

template <bool DETECT>
int launch(const float* x, const float* h, float* out, float* maxv, int* argv,
           float* sumv, int c, int l, int nf, cudaStream_t stream) {
  const int n_tiles = (l + kTile - 1) / kTile;
  if (c <= 0 || n_tiles <= 0) return 0;
  const size_t smem = (size_t)(3 * nf + kTile + nf) * sizeof(float2);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pss_kernel<DETECT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)n_tiles, (unsigned)c);
  pss_kernel<DETECT><<<grid, kThreads, smem, stream>>>(
      reinterpret_cast<const float2*>(x), reinterpret_cast<const float2*>(h),
      out, maxv, argv, sumv, l, nf, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (C, L) complex as interleaved f32 pairs; h: (3, nf) complex replicas
// (not conjugated); out: (C, 3, L) f32.  Returns cudaGetLastError().
extern "C" int lteax_pss_corr(const float* x, const float* h, float* out,
                              int c, int l, int nf, cudaStream_t stream) {
  return launch<false>(x, h, out, nullptr, nullptr, nullptr, c, l, nf, stream);
}

// As lteax_pss_corr, but writes per-tile partials (C, 3, n_tiles) instead:
// maxv f32, argv i32 (index within the tile, first maximum), sumv f32.
extern "C" int lteax_pss_detect(const float* x, const float* h, float* maxv,
                                int* argv, float* sumv, int c, int l, int nf,
                                cudaStream_t stream) {
  return launch<true>(x, h, nullptr, maxv, argv, sumv, c, l, nf, stream);
}
