// Max-log-MAP turbo half-iteration, one thread per (codeblock, window) chain.
//
// Replaces the TPU Pallas kernels lteax/kernels/turbo_mlm.py ::
// half_iteration_blane (_make_kernel_blane, the flipped tile) and
// half_iteration_pallas (_make_kernel_fused, the natural tile).  Both compute
// the same function; on the GPU it is one kernel on the natural (C, K+3)
// layout.  It reproduces _make_kernel_fused with pinned padding in f32:
//   1. acq acquisition steps of alpha (from the previous window's tail) and
//      beta (from the next window's head), each frozen where the trellis
//      position is outside [0, n) — this carries window 0's start pin and
//      the last window's termination pin;
//   2. a store phase over the first half of the window: the pre-step alpha
//      at t and the pre-step beta at win-1-t go to scratch;
//   3. a combine phase over the second half: once the chains have crossed,
//      each live metric combines at once with the opposite half's store
//      (grouped by gamma code), and the NII boundary metrics are exported at
//      t = win - acq.
// The alpha sweep runs unmasked; the beta main sweep adds +PIN to u on dead
// positions (u + PIN*(1-live)), which pins the metrics with no freeze blend.
// The 8-state wiring below is lteax.phy.fec.turbo._unrolled_wiring written
// out as straight-line code (the tests parse it back and compare), so every
// state index is a compile-time register index.
//
// What bounds it on an H100: latency of the serial trellis.  Each chain is
// ~(acq + win) dependent add/max steps; parallelism comes only from the
// C * n_w chains (13 * B * 46 at 20 MHz: 153k threads at B = 256, about one
// wave of the 132 SMs at 2048 threads each).  The win/2 x 8 alpha and beta
// stores go to a global scratch laid out step-major — [step][state][chain] —
// so a warp's 32 neighbouring chains write and read 128 contiguous bytes.
// u and v are read per chain along its window; neighbouring threads read 32
// different lines that the next steps reuse from L1.
//
// Built with -fmad=false: it equals the plain torch version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr float PIN = 512.0f;

// gamma codes: 0=+(u+v)/2, 1=+(u-v)/2, 2=-(u-v)/2, 3=-(u+v)/2
__device__ __forceinline__ void gammas(float u, float v, float g[4]) {
  float gpp = 0.5f * (u + v);
  float gpm = 0.5f * (u - v);
  g[0] = gpp;
  g[1] = gpm;
  g[2] = -gpm;
  g[3] = -gpp;
}

// alpha recursion: a'[s'] = max(a[p0] + g[g0], a[p1] + g[g1])
__device__ __forceinline__ void acs_fwd(float a[8], float u, float v) {
  float g[4];
  gammas(u, v, g);
  float n0 = fmaxf(a[0] + g[0], a[1] + g[3]);
  float n1 = fmaxf(a[2] + g[2], a[3] + g[1]);
  float n2 = fmaxf(a[4] + g[1], a[5] + g[2]);
  float n3 = fmaxf(a[6] + g[3], a[7] + g[0]);
  float n4 = fmaxf(a[0] + g[3], a[1] + g[0]);
  float n5 = fmaxf(a[2] + g[1], a[3] + g[2]);
  float n6 = fmaxf(a[4] + g[2], a[5] + g[1]);
  float n7 = fmaxf(a[6] + g[0], a[7] + g[3]);
  a[0] = n0; a[1] = n1; a[2] = n2; a[3] = n3;
  a[4] = n4; a[5] = n5; a[6] = n6; a[7] = n7;
}

// beta recursion: b'[s] = max(b[n0] + g[g0], b[n1] + g[g1])
__device__ __forceinline__ void acs_bwd(float b[8], float u, float v) {
  float g[4];
  gammas(u, v, g);
  float n0 = fmaxf(b[0] + g[0], b[4] + g[3]);
  float n1 = fmaxf(b[4] + g[0], b[0] + g[3]);
  float n2 = fmaxf(b[5] + g[1], b[1] + g[2]);
  float n3 = fmaxf(b[1] + g[1], b[5] + g[2]);
  float n4 = fmaxf(b[2] + g[1], b[6] + g[2]);
  float n5 = fmaxf(b[6] + g[1], b[2] + g[2]);
  float n6 = fmaxf(b[7] + g[0], b[3] + g[3]);
  float n7 = fmaxf(b[3] + g[0], b[7] + g[3]);
  b[0] = n0; b[1] = n1; b[2] = n2; b[3] = n3;
  b[4] = n4; b[5] = n5; b[6] = n6; b[7] = n7;
}

// APP LLR at the position of a (b = beta one step later): the 16 branch
// sums a[s] + b[next] grouped by gamma code, then l0 - l1.
__device__ __forceinline__ float combine(const float a[8], const float b[8],
                                         float u, float v) {
  float g[4];
  gammas(u, v, g);
  float m0 = fmaxf(fmaxf(fmaxf(a[0] + b[0], a[1] + b[4]), a[6] + b[7]), a[7] + b[3]);
  float m1 = fmaxf(fmaxf(fmaxf(a[2] + b[5], a[3] + b[1]), a[4] + b[2]), a[5] + b[6]);
  float m2 = fmaxf(fmaxf(fmaxf(a[2] + b[1], a[3] + b[5]), a[4] + b[6]), a[5] + b[2]);
  float m3 = fmaxf(fmaxf(fmaxf(a[0] + b[4], a[1] + b[0]), a[6] + b[3]), a[7] + b[7]);
  float l0 = fmaxf(m0 + g[0], m1 + g[1]);
  float l1 = fmaxf(m2 + g[2], m3 + g[3]);
  return l0 - l1;
}

__global__ void turbo_half_kernel(const float* __restrict__ u,
                                  const float* __restrict__ v,
                                  const float* __restrict__ a_init,
                                  const float* __restrict__ b_init,
                                  float* __restrict__ l_out,
                                  float* __restrict__ a_nii,
                                  float* __restrict__ b_nii,
                                  float* __restrict__ astore,
                                  float* __restrict__ bstore,
                                  int c, int n, int n_w, int win, int acq) {
  const long long chains = (long long)c * n_w;
  const long long ch = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= chains) return;
  const int cb = (int)(ch / n_w);
  const int w = (int)(ch % n_w);
  const float* uc = u + (long long)cb * n;
  const float* vc = v + (long long)cb * n;
  float* lc = l_out + (long long)cb * n;
  const int half = win / 2;
  const int base = w * win;

  float a[8], b[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    a[s] = a_init[ch * 8 + s];
    b[s] = b_init[ch * 8 + s];
  }

  // 1. acquisition, frozen on dead positions
  for (int t = 0; t < acq; ++t) {
    const int pa = base - acq + t;
    if (pa >= 0 && pa < n) acs_fwd(a, uc[pa], vc[pa]);
    const int pb = base + win + (acq - 1 - t);
    if (pb < n) acs_bwd(b, uc[pb], vc[pb]);
  }

  // 2. store phase: pre-step alpha at t, pre-step beta at j = win-1-t
  for (int t = 0; t < half; ++t) {
    float* as = astore + (long long)t * 8 * chains + ch;
#pragma unroll
    for (int s = 0; s < 8; ++s) as[s * chains] = a[s];
    const int pt = base + t;
    const bool lt = pt < n;
    acs_fwd(a, lt ? uc[pt] : 0.0f, lt ? vc[pt] : 0.0f);
    const int j = win - 1 - t;
    float* bs = bstore + (long long)(j - half) * 8 * chains + ch;
#pragma unroll
    for (int s = 0; s < 8; ++s) bs[s * chains] = b[s];
    const int pj = base + j;
    const bool lj = pj < n;
    const float uj = lj ? uc[pj] : 0.0f;
    acs_bwd(b, uj + (lj ? 0.0f : PIN), lj ? vc[pj] : 0.0f);
  }

  // 3. combine phase: the chains have crossed
  for (int t = half; t < win; ++t) {
    const int j = win - 1 - t;
    if (t == win - acq) {
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        a_nii[ch * 8 + s] = a[s];
        b_nii[ch * 8 + s] = b[s];
      }
    }
    const int pt = base + t;
    const int pj = base + j;
    const bool lt = pt < n;
    const bool lj = pj < n;
    const float ut = lt ? uc[pt] : 0.0f, vt = lt ? vc[pt] : 0.0f;
    const float uj = lj ? uc[pj] : 0.0f, vj = lj ? vc[pj] : 0.0f;
    float st[8], sj[8];
    const float* bs = bstore + (long long)(t - half) * 8 * chains + ch;
    const float* as = astore + (long long)j * 8 * chains + ch;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      st[s] = bs[s * chains];
      sj[s] = as[s * chains];
    }
    const float l_t = combine(a, st, ut, vt);
    const float l_j = combine(sj, b, uj, vj);
    if (lt) lc[pt] = l_t;
    if (lj) lc[pj] = l_j;
    acs_fwd(a, ut, vt);
    acs_bwd(b, uj + (lj ? 0.0f : PIN), vj);
  }
}

}  // namespace

// u, v: (c, n) f32; a_init, b_init: (c, n_w, 8) f32 (already pinned);
// l_out: (c, n) f32; a_nii, b_nii: (c, n_w, 8) f32 raw exports;
// astore, bstore: (win/2, 8, c*n_w) f32 scratch.  Returns cudaGetLastError.
extern "C" int lteax_turbo_half(const float* u, const float* v,
                                const float* a_init, const float* b_init,
                                float* l_out, float* a_nii, float* b_nii,
                                float* astore, float* bstore,
                                int c, int n, int n_w, int win, int acq,
                                cudaStream_t stream) {
  if (win % 2 != 0 || acq <= 0 || acq > win / 2 || n_w * win < n)
    return (int)cudaErrorInvalidValue;
  long long chains = (long long)c * n_w;
  int threads = 128;
  unsigned blocks = (unsigned)((chains + threads - 1) / threads);
  turbo_half_kernel<<<blocks, threads, 0, stream>>>(
      u, v, a_init, b_init, l_out, a_nii, b_nii, astore, bstore,
      c, n, n_w, win, acq);
  return (int)cudaGetLastError();
}
