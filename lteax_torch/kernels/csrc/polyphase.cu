// Rational P/Q polyphase resampler of complex streams.
//
// Replaces the TPU Pallas kernel lteax/kernels/polyphase.py ::
// resample_poly_pallas.  On the TPU the P subfilters ran as shifted
// (F, Q) @ (Q, P) matmuls against a dense (K_in, P) frame weight that is
// 12/K_in non-zero.  Here each thread computes output samples directly as
// the 12-tap FIR
//
//   y[j*P + r] = sum_t bank[(r*Q) mod P][t] * x[j*Q + off_r + T-1 - t],
//   off_r = floor(r*Q / P),
//
// i.e. it skips the weight's zeros.  A block owns frames_per_block frames
// of one channel: it stages the input span those frames read,
// x[j0*Q, (j0+F)*Q + K_in), in shared memory (neighbouring outputs share
// most of their taps' inputs), then each thread walks its outputs.
//
// Per output sample it reads 8*Q/P bytes of input once (via shared
// memory) and writes 8 bytes, against 48 flops, so the design makes one
// pass over the input and the output and keeps the bank (P x 12 f32) in
// L1.  Measured on an H100 it moves ~570 GB/s, a sixth of HBM: the
// integer div/mod per output and the 12 dependent taps bound it, not
// memory.
//
// Taps accumulate t = 0..T-1 in order, real and imaginary parts
// separately; built with -fmad=false the kernel equals the plain torch
// version (lteax_torch/kernels/polyphase.py) bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSpanTarget = 4096;   // input samples staged per block (approx.)

__global__ void __launch_bounds__(kThreads)
resample_kernel(const float2* __restrict__ x, const float* __restrict__ bank,
                float2* __restrict__ y, int l, int p, int q, int t,
                int n_frames, int frames_per_block, int k_in) {
  extern __shared__ float2 sx[];
  const int c = blockIdx.y;
  const long long j0 = (long long)blockIdx.x * frames_per_block;
  const int nf = (int)min((long long)frames_per_block, n_frames - j0);
  const float2* xc = x + (long long)c * l;
  const long long s0 = j0 * q;
  const int span = nf * q + k_in;
  for (int i = threadIdx.x; i < span; i += kThreads) {
    long long n = s0 + i;
    sx[i] = n < l ? xc[n] : make_float2(0.0f, 0.0f);
  }
  __syncthreads();
  float2* yc = y + (long long)c * n_frames * p + j0 * p;
  const int n_out = nf * p;
  for (int o = threadIdx.x; o < n_out; o += kThreads) {
    const int jj = o / p;
    const int r = o - jj * p;
    const long long rq = (long long)r * q;
    const float* b = bank + (rq % p) * t;
    const int base = jj * q + (int)(rq / p) + t - 1;
    float2 v = sx[base];
    float br = __ldg(b);
    float ar = br * v.x;
    float ai = br * v.y;
    for (int k = 1; k < t; ++k) {
      v = sx[base - k];
      br = __ldg(b + k);
      ar = ar + br * v.x;
      ai = ai + br * v.y;
    }
    yc[o] = make_float2(ar, ai);
  }
}

}  // namespace

// x: (C, L) complex as interleaved f32 pairs; bank: (P, T) f32;
// y: (C, n_frames*P) interleaved.  Returns cudaGetLastError().
extern "C" int lteax_resample(const float* x, const float* bank, float* y,
                              int c, int l, int p, int q, int t, int n_frames,
                              cudaStream_t stream) {
  if (c <= 0 || n_frames <= 0) return 0;
  const int max_off = (int)(((long long)(p - 1) * q) / p);
  const int k_in = max_off + t;
  int fpb = kSpanTarget / q;
  if (fpb < 1) fpb = 1;
  const size_t smem = (size_t)(fpb * q + k_in) * sizeof(float2);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        resample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)((n_frames + fpb - 1) / fpb), (unsigned)c);
  resample_kernel<<<grid, kThreads, smem, stream>>>(
      reinterpret_cast<const float2*>(x), bank, reinterpret_cast<float2*>(y),
      l, p, q, t, n_frames, fpb, k_in);
  return (int)cudaGetLastError();
}
