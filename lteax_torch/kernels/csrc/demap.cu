// Fused max-log QAM demap + LLR scaling + descramble, planar output.
//
// Replaces the TPU Pallas kernel lteax/kernels/demap.py ::
// demap_descr_planar_pallas (_make_kernel).  For the Gray square QAM schemes
// the max-log subset minimum factorizes per axis: each axis is an L-level
// PAM problem (L = 2, 4, 8 for QPSK, 16QAM, 64QAM).  One thread owns one
// (subframe, column): it loads xr, xi and 1/eff_nv once, keeps the 2*L
// squared distances in registers, and writes its m LLRs to the m planes
// out[b, plane, col] — neighbouring threads write neighbouring columns, so
// every store is coalesced.
//
// What bounds it on an H100: device-memory bandwidth.  At 64QAM f32 a
// column reads 12 B (plus 24 B of sign planes that stay in L2, being shared
// by every subframe) and writes 24 B, against ~40 flops; the arithmetic is
// far below the card's rate.  The design therefore does one pass over HBM
// and no intermediate stores.
//
// Arithmetic is the reference's, in its order: d_k = (y - s_k)^2,
// d0/d1 = min over the bit-0/bit-1 subsets, LLR = (d1 - d0) * scale * sgn.
// A zero sign gives an exact 0.0 (non-PDSCH columns, the de-match zero slot).
// Built with -fmad=false, so it equals the plain torch version bit for bit.

#include <cuda_runtime.h>

namespace {

struct Levels {
  float v[8];
};

// bit j (MSB first) of PAM level index i, as _pam_axis's bit_is_one[j, i]
template <int MA>
__device__ __forceinline__ bool bit_one(int j, int i) {
  return (i >> (MA - 1 - j)) & 1;
}

template <int MA>
__global__ void demap_kernel(const float* __restrict__ xr,
                             const float* __restrict__ xi,
                             const float* __restrict__ inv_nv,
                             const float* __restrict__ sgn,
                             float* __restrict__ out,
                             int bsz, int n, int npad, Levels lv) {
  constexpr int L = 1 << MA;
  constexpr int M = 2 * MA;
  long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)bsz * npad) return;
  int b = (int)(tid / npad);
  int col = (int)(tid % npad);
  long long src = (long long)b * n + col;
  // columns past n are the lane padding of the planar layout: zero inputs
  float y[2], scale;
  if (col < n) {
    y[0] = xr[src];
    y[1] = xi[src];
    scale = inv_nv[src];
  } else {
    y[0] = 0.0f;
    y[1] = 0.0f;
    scale = 0.0f;
  }
  float* o = out + (long long)b * M * npad + col;
#pragma unroll
  for (int axis = 0; axis < 2; ++axis) {
    float d[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      float e = y[axis] - lv.v[i];
      d[i] = e * e;
    }
#pragma unroll
    for (int j = 0; j < MA; ++j) {
      float d0 = 0.0f, d1 = 0.0f;
      bool h0 = false, h1 = false;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        if (bit_one<MA>(j, i)) {
          d1 = h1 ? fminf(d1, d[i]) : d[i];
          h1 = true;
        } else {
          d0 = h0 ? fminf(d0, d[i]) : d[i];
          h0 = true;
        }
      }
      int plane = 2 * j + axis;   // bit order (b0|I, b1|Q, b2|I, ...)
      o[(long long)plane * npad] = (d1 - d0) * scale * sgn[plane * npad + col];
    }
  }
}

}  // namespace

// xr, xi, inv_nv: (bsz, n) f32; sgn: (m, npad) f32; out: (bsz, m, npad) f32.
// levels: host pointer to the 2^(m/2) PAM levels.  Returns cudaGetLastError.
extern "C" int lteax_demap(const float* xr, const float* xi,
                           const float* inv_nv, const float* sgn, float* out,
                           int bsz, int n, int npad, int m,
                           const float* levels, cudaStream_t stream) {
  Levels lv = {};
  int ma = m / 2;
  for (int i = 0; i < (1 << ma); ++i) lv.v[i] = levels[i];
  long long total = (long long)bsz * npad;
  int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  switch (ma) {
    case 1:
      demap_kernel<1><<<blocks, threads, 0, stream>>>(xr, xi, inv_nv, sgn, out,
                                                      bsz, n, npad, lv);
      break;
    case 2:
      demap_kernel<2><<<blocks, threads, 0, stream>>>(xr, xi, inv_nv, sgn, out,
                                                      bsz, n, npad, lv);
      break;
    case 3:
      demap_kernel<3><<<blocks, threads, 0, stream>>>(xr, xi, inv_nv, sgn, out,
                                                      bsz, n, npad, lv);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
