// The turbo decoder's glue between two half-iterations, one pass a row.
//
// Replaces no TPU kernel: the reference leaves this glue to XLA (the
// extrinsic update, the QPP gathers, the NII roll and normalisation and the
// CRC parity around half_iteration_blane in turbo_decode_batch_pallas's
// layout path).  The port ran it as some twenty torch launches a half, each
// reading or writing the whole (C, K) batch, the gathers through a
// permutation; this kernel does the same arithmetic in one launch.  Its
// plain version is turbo_mlm.py :: turbo_glue_plain.
//
// After a half-iteration that read u (C, K+3) and wrote l (C, K+3), it gives
// the other half's input and boundaries:
//   ext[i]      = bf16(scale * bf16(l[i] - u[i]))           i < K
//   u_next[j]   = bf16(s[j] + ext[perm[j]])                 j < K
//   u_next[K+t] = st[t]                                     t < 3
// (after DEC1: s the interleaved systematic LLRs, perm the QPP pi; after
// DEC2: s the natural ones, perm its inverse), the next call's boundary
// metrics from the raw NII exports (alpha rolled one window on, beta one
// window back, each window's max over the 8 states subtracted, window 0's
// alpha and the last window's beta pinned to state 0), and, where asked
// (kCrc), each row's CRC parity: the syndrome of the hard decisions l < 0 as
// an XOR of the parity matrix's rows packed into 32 bits, one flag a row;
// and (kBits) the hard decisions in the order perm gives, as int8.
//
// What bounds it on an H100: bytes.  A row reads l, u and s and writes u_next
// (2 bytes a position each), plus the NII metrics (128 bytes a window in and
// out): ~350 MB a half at C = 6656, K = 5824, 0.10 ms at 3.35 TB/s.  The
// arithmetic is a handful of operations a position.  The design:
//   - one block a codeblock row: the permutation spans the row, so the row's
//     extrinsic goes into shared memory (2 bytes a position, 11.6 KB at
//     K = 5824) and is gathered from there, never through device memory;
//   - every device-memory access is in row order, neighbouring threads on
//     neighbouring positions (coalesced), each thread's loads issued kUnroll
//     at a time ahead of their use; rows of K+3 positions start at any even
//     byte, and s may be a strided view, so accesses are per element rather
//     than 16-byte vectors;
//   - the permutation is an int16 table and the CRC rows a uint32 table, K
//     entries each, read by every block: they stay in L1 and L2;
//   - the syndrome is XOR-reduced within a warp by shuffles, then across the
//     block's warps in shared memory; GF(2) sums are exact, so the flag equals
//     the f32 matrix product's parity test bit for bit.
// Each bf16 result rounds once, from the f32 operation on bf16 operands, as
// torch's bf16 arithmetic does; with -fmad=false the outputs equal the plain
// version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e9f;  // the pin's dead states (turbo_mlm.NEG)

__device__ __forceinline__ float wide(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <bool kCrc, bool kBits>
__global__ void __launch_bounds__(kThreads)
turbo_glue_kernel(const __nv_bfloat16* __restrict__ l, long long ld_l,
                  const __nv_bfloat16* __restrict__ u, long long ld_u,
                  const __nv_bfloat16* __restrict__ s, long long ld_s,
                  const __nv_bfloat16* __restrict__ st, long long ld_st,
                  const int16_t* __restrict__ perm,
                  const uint32_t* __restrict__ crc_rows, float scale, int k,
                  int n_w, const float* __restrict__ a_nii,
                  const float* __restrict__ b_nii,
                  __nv_bfloat16* __restrict__ u_next,
                  float* __restrict__ a_next, float* __restrict__ b_next,
                  uint8_t* __restrict__ ok, int8_t* __restrict__ bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ext = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* neg = smem + 2 * k;  // kBits: l < 0, in l's order
  __shared__ uint32_t warp_syn[kWarps];

  const long long r = blockIdx.x;
  const int tid = threadIdx.x;
  const __nv_bfloat16* lr = l + r * ld_l;
  const __nv_bfloat16* ur = u + r * ld_u;

  // 1. the extrinsic into shared memory, the syndrome and the signs
  uint32_t syn = 0;
  for (int base = tid; base < k; base += kThreads * kUnroll) {
    __nv_bfloat16 lv[kUnroll], uv[kUnroll];
    uint32_t cv[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const int i = base + q * kThreads;
      if (i < k) {
        lv[q] = lr[i];
        uv[q] = ur[i];
        if (kCrc) cv[q] = crc_rows[i];
      }
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const int i = base + q * kThreads;
      if (i < k) {
        const float lf = wide(lv[q]);
        const float d = wide(__float2bfloat16_rn(lf - wide(uv[q])));
        ext[i] = __float2bfloat16_rn(scale * d);
        if (kCrc && lf < 0.f) syn ^= cv[q];
        if (kBits) neg[i] = lf < 0.f;
      }
    }
  }

  // 2. the NII hand-over: 8 lanes a window, one state each (whole warps
  // run every turn, so the shuffles take the full mask)
  const int n_st = n_w * 8;
  const float* ar = a_nii + r * n_st;
  const float* br = b_nii + r * n_st;
  for (int base = 0; base < n_st; base += kThreads) {
    const int idx = base + tid;
    const bool live = idx < n_st;
    const int w = idx >> 3, x = idx & 7;
    const int wa = (w == 0 ? n_w : w) - 1;     // roll alpha by +1 window
    const int wb = (w + 1 >= n_w) ? 0 : w + 1;  // roll beta by -1 window
    const float av = live ? ar[wa * 8 + x] : 0.f;
    const float bv = live ? br[wb * 8 + x] : 0.f;
    float am = av, bm = bv;
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      am = fmaxf(am, __shfl_xor_sync(kFull, am, o));
      bm = fmaxf(bm, __shfl_xor_sync(kFull, bm, o));
    }
    if (live) {
      const float pin = x == 0 ? 0.f : kNeg;
      a_next[r * n_st + idx] = w == 0 ? pin : av - am;
      b_next[r * n_st + idx] = w == n_w - 1 ? pin : bv - bm;
    }
  }

  // 3. the row's syndrome, warp then block
  if (kCrc) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) syn ^= __shfl_xor_sync(kFull, syn, o);
    if ((tid & 31) == 0) warp_syn[tid >> 5] = syn;
  }
  __syncthreads();
  if (kCrc && tid == 0) {
    uint32_t t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t ^= warp_syn[w];
    ok[r] = t == 0;
  }

  // 4. the next half's input, gathered through the permutation
  const __nv_bfloat16* sr = s + r * ld_s;
  __nv_bfloat16* out = u_next + r * (long long)(k + 3);
  int8_t* br_bits = kBits ? bits + r * (long long)k : nullptr;
  for (int base = tid; base < k; base += kThreads * kUnroll) {
    int p[kUnroll];
    __nv_bfloat16 sv[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const int j = base + q * kThreads;
      if (j < k) {
        p[q] = perm[j];
        sv[q] = sr[j];
      }
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const int j = base + q * kThreads;
      if (j < k) {
        out[j] = __float2bfloat16_rn(wide(sv[q]) + wide(ext[p[q]]));
        if (kBits) br_bits[j] = neg[p[q]];
      }
    }
  }
  if (tid < 3) out[k + tid] = st[r * ld_st + tid];
}

template <bool kCrc, bool kBits>
int launch(const void* l, long long ld_l, const void* u, long long ld_u,
           const void* s, long long ld_s, const void* st, long long ld_st,
           const void* perm, const void* crc_rows, float scale, int c, int k,
           int n_w, const float* a_nii, const float* b_nii, void* u_next,
           float* a_next, float* b_next, void* ok, void* bits,
           cudaStream_t stream) {
  const size_t shmem = 2 * (size_t)k + (kBits ? (size_t)k : 0);
  turbo_glue_kernel<kCrc, kBits><<<c, kThreads, shmem, stream>>>(
      static_cast<const __nv_bfloat16*>(l), ld_l,
      static_cast<const __nv_bfloat16*>(u), ld_u,
      static_cast<const __nv_bfloat16*>(s), ld_s,
      static_cast<const __nv_bfloat16*>(st), ld_st,
      static_cast<const int16_t*>(perm),
      static_cast<const uint32_t*>(crc_rows), scale, k, n_w, a_nii, b_nii,
      static_cast<__nv_bfloat16*>(u_next), a_next, b_next,
      static_cast<uint8_t*>(ok), static_cast<int8_t*>(bits));
  return (int)cudaGetLastError();
}

}  // namespace

// The glue after one half-iteration, for c codeblock rows of K = k
// (turbo_mlm.turbo_glue).  crc_rows and ok are both given or both null;
// bits only with them.  K up to 6144, LTE's largest: 18 KB of shared
// memory.
extern "C" int lteax_turbo_glue(const void* l, long long ld_l, const void* u,
                                long long ld_u, const void* s, long long ld_s,
                                const void* st, long long ld_st,
                                const void* perm, const void* crc_rows,
                                float scale, int c, int k, int n_w,
                                const float* a_nii, const float* b_nii,
                                void* u_next, float* a_next, float* b_next,
                                void* ok, void* bits, cudaStream_t stream) {
  if (k <= 0 || k > 6144 || n_w <= 0 ||
      (crc_rows == nullptr) != (ok == nullptr) || (bits && !ok))
    return (int)cudaErrorInvalidValue;
  if (c <= 0) return 0;
  auto fn = !ok ? &launch<false, false>
                : bits ? &launch<true, true> : &launch<true, false>;
  return fn(l, ld_l, u, ld_u, s, ld_s, st, ld_st, perm, crc_rows, scale, c,
            k, n_w, a_nii, b_nii, u_next, a_next, b_next, ok, bits, stream);
}
