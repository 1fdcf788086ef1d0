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
//
// The reference's bf16 staging (DecoderTuning.demap_in = "bf16") and bf16
// planar output (out_dtype = bf16, a bf16 trellis) are the template
// arguments TI and TO: xr, xi and 1/eff_nv are read in TI and widened, the
// arithmetic stays f32, and each LLR rounds once to TO (round to nearest
// even) as it is stored.  The sign planes stay f32.

#include <cuda_bf16.h>
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

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T narrow(float x) {
  if constexpr (sizeof(T) == 2) return __float2bfloat16_rn(x);
  else return x;
}

template <int MA, typename TI, typename TO>
__global__ void demap_kernel(const TI* __restrict__ xr,
                             const TI* __restrict__ xi,
                             const TI* __restrict__ inv_nv,
                             const float* __restrict__ sgn,
                             TO* __restrict__ out,
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
    y[0] = widen(xr[src]);
    y[1] = widen(xi[src]);
    scale = widen(inv_nv[src]);
  } else {
    y[0] = 0.0f;
    y[1] = 0.0f;
    scale = 0.0f;
  }
  TO* o = out + (long long)b * M * npad + col;
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
      o[(long long)plane * npad] =
          narrow<TO>((d1 - d0) * scale * sgn[plane * npad + col]);
    }
  }
}

}  // namespace

template <typename TI, typename TO>
static int launch(const void* xr, const void* xi, const void* inv_nv,
                  const float* sgn, void* out, int bsz, int n, int npad,
                  int ma, const Levels& lv, cudaStream_t stream) {
  long long total = (long long)bsz * npad;
  int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  const TI* r = static_cast<const TI*>(xr);
  const TI* i = static_cast<const TI*>(xi);
  const TI* s = static_cast<const TI*>(inv_nv);
  TO* o = static_cast<TO*>(out);
  switch (ma) {
    case 1:
      demap_kernel<1, TI, TO><<<blocks, threads, 0, stream>>>(
          r, i, s, sgn, o, bsz, n, npad, lv);
      break;
    case 2:
      demap_kernel<2, TI, TO><<<blocks, threads, 0, stream>>>(
          r, i, s, sgn, o, bsz, n, npad, lv);
      break;
    case 3:
      demap_kernel<3, TI, TO><<<blocks, threads, 0, stream>>>(
          r, i, s, sgn, o, bsz, n, npad, lv);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// xr, xi, inv_nv: (bsz, n) f32, or bf16 when in_bf16; sgn: (m, npad) f32;
// out: (bsz, m, npad) f32, or bf16 when out_bf16.  levels: host pointer to
// the 2^(m/2) PAM levels.  Returns cudaGetLastError.
extern "C" int lteax_demap(const void* xr, const void* xi, const void* inv_nv,
                           const float* sgn, void* out, int bsz, int n,
                           int npad, int m, const float* levels, int in_bf16,
                           int out_bf16, cudaStream_t stream) {
  Levels lv = {};
  int ma = m / 2;
  if (ma < 1 || ma > 3) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < (1 << ma); ++i) lv.v[i] = levels[i];
  using bf16 = __nv_bfloat16;
  if (in_bf16)
    return out_bf16 ? launch<bf16, bf16>(xr, xi, inv_nv, sgn, out, bsz, n,
                                         npad, ma, lv, stream)
                    : launch<bf16, float>(xr, xi, inv_nv, sgn, out, bsz, n,
                                          npad, ma, lv, stream);
  return out_bf16 ? launch<float, bf16>(xr, xi, inv_nv, sgn, out, bsz, n,
                                        npad, ma, lv, stream)
                  : launch<float, float>(xr, xi, inv_nv, sgn, out, bsz, n,
                                         npad, ma, lv, stream);
}
