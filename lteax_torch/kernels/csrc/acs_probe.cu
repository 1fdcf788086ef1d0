// ACS op-mix rate probe: R rounds of a = max(a + b, b); b = max(b + a, a),
// elementwise, from b0 = a0 * 1.0009765625, output a.
//
// Replaces the TPU Pallas kernel bench/vpu_bf16_probe.py :: _kernel (run).
// The chain is the add/max mix of the turbo decoder's add-compare-select
// step, and the probe's question is whether the 16-bit form runs at twice
// the f32 rate on this card (it gates a bf16 trellis).
//
// What bounds it on an H100: operations.  An element moves 8 B (f32) or
// 4 B (bf16) through device memory and does 4 * R adds and maxes, so from
// R ~ 20 on the arithmetic pipes set the time.  The design keeps a and b in
// registers for the whole chain and touches memory twice: the f32 entry
// takes one element per thread; the bf16 entry takes one packed pair per
// thread (__nv_bfloat162, __hadd2 / __hmax2), the only form in which the
// 16-bit pipes can run two lanes per instruction.  The chain depends on the
// data at every step, so no compiler can shorten it.
//
// Every add rounds once to the working type, as the plain torch version
// does op by op, so the two agree bit for bit (inf included: positive
// lanes grow like Fibonacci numbers and saturate; no inf - inf arises).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void acs_chain_f32(const float* __restrict__ x,
                              float* __restrict__ out, long long n,
                              int rounds) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = x[i];
  float b = a * 1.0009765625f;
#pragma unroll 8
  for (int r = 0; r < rounds; ++r) {
    a = fmaxf(a + b, b);
    b = fmaxf(b + a, a);
  }
  out[i] = a;
}

__global__ void acs_chain_bf16x2(const __nv_bfloat162* __restrict__ x,
                                 __nv_bfloat162* __restrict__ out,
                                 long long n_pairs, int rounds) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pairs) return;
  __nv_bfloat162 a = x[i];
  // the scale is rounded to bf16 first (it becomes 1.0), as a bf16 tensor
  // times a scalar is in the reference
  __nv_bfloat162 b = __hmul2(a, __float2bfloat162_rn(1.0009765625f));
#pragma unroll 8
  for (int r = 0; r < rounds; ++r) {
    a = __hmax2(__hadd2(a, b), b);
    b = __hmax2(__hadd2(b, a), a);
  }
  out[i] = a;
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// x, out: n f32 elements.  Returns cudaGetLastError().
extern "C" int lteax_acs_chain_f32(const float* x, float* out, long long n,
                                   int rounds, cudaStream_t stream) {
  if (n <= 0) return 0;
  acs_chain_f32<<<blocks_for(n), kThreads, 0, stream>>>(x, out, n, rounds);
  return (int)cudaGetLastError();
}

// x, out: n_pairs packed bf16 pairs (2 * n_pairs elements, 4-byte aligned).
extern "C" int lteax_acs_chain_bf16(const void* x, void* out,
                                    long long n_pairs, int rounds,
                                    cudaStream_t stream) {
  if (n_pairs <= 0) return 0;
  acs_chain_bf16x2<<<blocks_for(n_pairs), kThreads, 0, stream>>>(
      reinterpret_cast<const __nv_bfloat162*>(x),
      reinterpret_cast<__nv_bfloat162*>(out), n_pairs, rounds);
  return (int)cudaGetLastError();
}
