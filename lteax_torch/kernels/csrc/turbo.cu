// Max-log-MAP turbo half-iteration, resident in shared memory: a block owns
// W consecutive windows of one codeblock, 8 lanes carry each window's chain.
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
//      at t and the pre-step beta at win-1-t are kept;
//   3. a combine phase over the second half: once the chains have crossed,
//      each live metric combines at once with the opposite half's store
//      (grouped by gamma code), and the NII boundary metrics are exported at
//      t = win - acq.
// The alpha sweep runs unmasked; the beta main sweep pins dead positions
// (u + PIN, v = 0 there: both gammas are PIN/2 exactly).
//
// What bounds it on an H100: bytes by the roofline (u, v in, L out: 0.075 ms
// at C = 3328, n = 5827), but what decides the time is latency.  A chain is
// acq + win dependent steps, its win/2 x 8 alpha and beta stores are 4 KB,
// and 227 KB of shared memory hold ~40 chains an SM: ten warps, each
// issuing in order, so a step costs the sum of what it waits for (a
// shuffle, a shared-memory load, five dependent f32 operations), and the
// card idles between them.  Measured per block of 8 windows, by clock64:
// 32k clocks, of which the combine phase 13k, the store phase 8k, staging
// and set-up 4k, the write-out 4k, acquisition 2.5k.  The design:
//   - the block's u and v are one contiguous slab of the row, halos of acq
//     on both sides, copied from device memory by cp.async, all at once (a
//     loop of loads pays the memory's latency per turn), zero outside
//     [0, n); one padding slot per window keeps the chains of a warp on
//     different banks;
//   - the stores stay in shared memory (4160 bytes a chain); the wrapper
//     allocates no scratch;
//   - a chain is 8 lanes, 4 per direction, a butterfly each.  The trellis is
//     a shift register: states 2k and 2k+1 lead to k and k+4 under one gamma
//     and its negative, so a lane that holds the pair (a[2k], a[2k+1])
//     computes (a'[k], a'[k+4]) alone (4 adds, 2 maxes), and exchanging one
//     register with the lane across one bit of its index makes pairs again:
//     one shuffle a step, alpha and beta in the same instruction.  The
//     pairing alternates between two phases; the loops are unrolled by two;
//   - every shuffle takes the full mask and every warp runs whole and in
//     step (a window beyond the row computes on zeros and writes nothing): a
//     shuffle under a partial mask sits behind a divergence check that ends
//     a basic block, and the compiler schedules nothing across it;
//   - a warp issues in order, so what a step needs is asked for early: u and
//     v are read two steps ahead, the next step's gamma is formed in the
//     shadow of this step's shuffle, and the combine's fold to L (three
//     dependent shuffles) runs as a pipeline, one stage per step, its
//     shuffles issued back to back with the trellis step's;
//   - L goes into the store slot that its combine step has consumed and
//     leaves as whole rows, coalesced, masked at n.
// Adds and maxes are exact per operation and a max may be taken in any
// order, so with -fmad=false the result equals the plain torch version bit
// for bit.
//
// The reference's other forms are a template argument and a flag of the
// same kernel:
//   - a bf16 trellis (bf16 u, v, stores and L; the reference's
//     "bf16_f32store" holds the same bf16 values in f32 stores, so it runs
//     this form too).  The registers hold f32 values that are bf16 values,
//     and every ACS add, gamma and renormalisation rounds back to bf16 at
//     once (rnd): f32 has 24 >= 2 * 8 + 2 bits, so one f32 operation on
//     two bf16 values rounded to bf16 is the correctly rounded bf16
//     operation, as torch's per-operation bf16 on the CPU and the
//     reference's bf16 are.  The inits round to bf16 on loading; the
//     combine sums in f32 and L rounds once; the main sweeps renormalise
//     (x -= x[0], state 0 from lane 0 of the direction by one shuffle)
//     every `period` steps, as the reference's kernels do whatever their
//     unroll; the acquisition never does;
//   - the freeze (pinpad=False): a dead position of the beta main sweep
//     keeps the old beta, so the step is skipped as the acquisition skips
//     one.  The dead steps are the first t_pin of the last window's sweep,
//     so its chain starts in the phase of step t_pin and holds it across
//     them.  (bf16's blend m*new + (1-m)*old keeps the old value too, up to
//     the sign of a zero, which no comparison sees.)
//
// The 8-state wiring is lteax.phy.fec.turbo._unrolled_wiring written out as
// the two tables below (the tests parse them back and compare): a row of
// FWD is (p0, p1, g0, g1) of a'[s'] = max(a[p0] + g[g0], a[p1] + g[g1]), a
// row of BWD is (n0, n1, g0, g1) of b'[s] = max(b[n0] + g[g0], b[n1] +
// g[g1]).  The kernel reads its wiring from them, and a static_assert holds
// them to the butterfly structure its lane layout needs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define TRELLIS_FWD {{0, 1, 0, 3}, {2, 3, 2, 1}, {4, 5, 1, 2}, {6, 7, 3, 0}, \
                     {0, 1, 3, 0}, {2, 3, 1, 2}, {4, 5, 2, 1}, {6, 7, 0, 3}}
#define TRELLIS_BWD {{0, 4, 0, 3}, {4, 0, 0, 3}, {5, 1, 1, 2}, {1, 5, 1, 2}, \
                     {2, 6, 1, 2}, {6, 2, 1, 2}, {7, 3, 0, 3}, {3, 7, 0, 3}}

namespace {

constexpr float HALF_PIN = 256.0f;   // both gammas of a pinned dead position
constexpr int kLanes = 8;            // per chain: 4 alpha lanes, 4 beta lanes

// gamma codes: 0=+(u+v)/2, 1=+(u-v)/2, 2=-(u-v)/2, 3=-(u+v)/2
constexpr int kFwdHost[8][4] = TRELLIS_FWD;
constexpr int kBwdHost[8][4] = TRELLIS_BWD;

// The code of the branch 2k -> k (it is also 2k+1 -> k+4's; the two other
// branches of the butterfly, 2k -> k+4 and 2k+1 -> k, carry 3 minus it).
constexpr int butterfly_code(int k) { return kFwdHost[k][2]; }

// What the kernel's layout relies on, checked against the tables:
//  - the trellis is a shift register: states 2k and 2k+1 both lead to k and
//    k+4, so a lane that holds a pair computes a whole butterfly;
//  - the four branches of a butterfly carry two codes that sum to 3, hence
//    one gamma and its negative;
//  - butterflies 0 and 3 carry codes {0, 3}, butterflies 1 and 2 codes
//    {1, 2}: lanes 0, 3 and lanes 1, 2 fold together in the combine.
constexpr bool tables_are_butterflies() {
  for (int k = 0; k < 4; ++k) {
    const int c = butterfly_code(k);
    for (int hi = 0; hi < 2; ++hi) {           // FWD rows k and k + 4
      const int* f = kFwdHost[k + 4 * hi];
      if (f[0] != 2 * k || f[1] != 2 * k + 1) return false;
      if (f[2] != (hi ? 3 - c : c) || f[3] != 3 - f[2]) return false;
    }
    for (int odd = 0; odd < 2; ++odd) {        // BWD rows 2k and 2k + 1
      const int* r = kBwdHost[2 * k + odd];
      const bool straight = r[0] == k && r[1] == k + 4;
      const bool crossed = r[0] == k + 4 && r[1] == k;
      if (!straight && !crossed) return false;
      if (r[2] + r[3] != 3) return false;
      // the code of the branch to state k, seen from state 2k + odd
      if ((straight ? r[2] : r[3]) != (odd ? 3 - c : c)) return false;
    }
  }
  const auto cls = [](int k) {
    const int c = butterfly_code(k);
    return c < 2 ? c : 3 - c;
  };
  return cls(0) == 0 && cls(3) == 0 && cls(1) == 1 && cls(2) == 1;
}
static_assert(tables_are_butterflies(),
              "the kernel's lane layout needs the LTE trellis's structure");

__constant__ int kFwd[8][4] = TRELLIS_FWD;
__constant__ int kBwd[8][4] = TRELLIS_BWD;

__device__ __forceinline__ float with_sign(float x, unsigned sign) {
  return __uint_as_float(__float_as_uint(x) ^ sign);
}

// The metric arithmetic: in a bf16 form every result rounds to bf16
// (round to nearest even), in f32 nothing rounds.
template <bool kB>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (kB) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (sizeof(T) == 2) return __float2bfloat16_rn(x);
  else return x;
}

// A store slot of type T that a combine step writes its L into: L leaves
// the combine's f32 sums rounded once to the metric type.
template <typename T>
struct LSlot {
  T v;
  __device__ __forceinline__ void operator=(float x) { v = from_f32<T>(x); }
};

// a pair of metrics in a store (8 bytes in f32, 4 in bf16)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Lane q of a direction holds one butterfly's pair of metrics in (r0, r1):
// in phase 0 butterfly q, in phase 1 butterfly swap2(q) (q's two bits
// exchanged).  An alpha pair k is (a[2k], a[2k+1]) and a step turns it into
// (a'[k], a'[k+4]); a beta pair k is (b[k], b[k+4]) and a step turns it into
// (b'[2k], b'[2k+1]).  Exchanging one register with the lane across one bit
// of q then makes pairs again, in the other phase: one shuffle per step.
struct Phase {
  int pair;            // butterfly index k held before the step
  unsigned vsign;      // the step's gamma is (u + v)/2 or, with this sign
                       // bit on v, (u - v)/2 ...
  unsigned sign;       // ... with this sign bit on the result
  int swap;            // lane bit (1 or 2) the step's exchange crosses
  int bit0_is_p;       // combine: P = max(x+p, y+q) is the bit-0 maximum
};

constexpr unsigned kSignBit = 0x80000000u;

__device__ __forceinline__ int swap2(int q) { return ((q & 1) << 1) | (q >> 1); }

// gamma of code `code` at a position with inputs (u, v): +-(u +- v)/2, the
// inner sign on v and the outer sign given as sign bits
__device__ __forceinline__ unsigned inner_sign(int code) {
  return code == 1 || code == 2 ? kSignBit : 0u;
}
__device__ __forceinline__ unsigned outer_sign(int code) {
  return code >= 2 ? kSignBit : 0u;
}
__device__ __forceinline__ float gamma_of(float2 uv, unsigned vsign,
                                          unsigned sign) {
  return with_sign(0.5f * (uv.x + with_sign(uv.y, vsign)), sign);
}
// ... and in the metric type: each of the sum and the halving rounds
template <bool kB>
__device__ __forceinline__ float gamma_m(float2 uv, unsigned vsign,
                                         unsigned sign) {
  return with_sign(rnd<kB>(0.5f * rnd<kB>(uv.x + with_sign(uv.y, vsign))),
                   sign);
}

__device__ Phase make_phase(int d, int q, int ph) {
  Phase p;
  const int k = ph ? swap2(q) : q;
  p.pair = k;
  // alpha: a'[k] = max(a[2k] + g, a[2k+1] - g) with g of FWD[k].g0;
  // beta: b'[2k] = max(b[k] + g, b[k+4] - g) with g of the branch to b[k]
  const int code = d == 0 ? kFwd[k][2]
                          : (kBwd[2 * k][0] == k ? kBwd[2 * k][2]
                                                 : kBwd[2 * k][3]);
  p.vsign = inner_sign(code);
  p.sign = outer_sign(code);
  // alpha crosses bit 0 after a phase-0 step and bit 1 after a phase-1
  // step; beta the other way round
  p.swap = (ph == d) ? 1 : 2;
  p.bit0_is_p = kFwd[k][2] < 2;
  return p;
}

// 4 bytes from device memory to shared memory, without a register between
__device__ __forceinline__ void cp_async4(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

// slab index of the position `rel` samples from the block's first window
// (rel >= -acq): acq halo slots, then win + 1 slots per window
__device__ __forceinline__ int slab_index(int rel, int win, int acq) {
  return rel + acq + (rel + win) / win;
}

// T: the metric type of u, v, L and the alpha/beta stores (float, or bf16
// for the bf16 trellis).  freeze: the beta main sweep keeps the old beta at
// dead positions instead of pinning them.
template <typename T>
__global__ void turbo_half_kernel(const T* __restrict__ u,
                                  const T* __restrict__ v,
                                  const float* __restrict__ a_init,
                                  const float* __restrict__ b_init,
                                  T* __restrict__ l_out,
                                  float* __restrict__ a_nii,
                                  float* __restrict__ b_nii,
                                  int n, int n_w, int win, int acq, int wpb,
                                  int blocks_per_row, int freeze) {
  constexpr bool kB = sizeof(T) == 2;
  extern __shared__ float smem[];
  const int half = win / 2;
  const int period = half % 4 == 0 ? 4 : 2;    // bf16 renormalisation
  const int dir_stride = half * 8 + 8;         // one direction's store + pad
  const int chain_stride = 2 * dir_stride;
  const int slab = wpb * win + 2 * acq;        // positions staged
  const int slab_slots = slab + wpb + 1;
  float2* uv = reinterpret_cast<float2*>(smem);   // (u, v) per position
  T* store = reinterpret_cast<T*>(smem + 2 * slab_slots);

  const int cb = blockIdx.x / blocks_per_row;
  const int w0 = (blockIdx.x % blocks_per_row) * wpb;
  const long long row = (long long)cb * n;
  const int p0 = w0 * win;

  // the lanes' wiring, worked out once by 16 threads
  __shared__ Phase phases[2][kLanes];
  if (threadIdx.x < 2 * kLanes)
    phases[threadIdx.x >> 3][threadIdx.x & 7] = make_phase(
        (threadIdx.x >> 2) & 1, threadIdx.x & 3, threadIdx.x >> 3);

  // The block's u, v slab, zero outside [0, n) and in the pad slots: every
  // copy is in flight at once (a loop of loads would pay the device
  // memory's latency per turn).  bf16 inputs are read and widened by the
  // threads (cp.async moves 4 bytes at least).
  for (int i = threadIdx.x; i < slab; i += blockDim.x) {
    const int rel = i - acq;
    const int pos = p0 + rel;
    float2* dst = uv + slab_index(rel, win, acq);
    if (pos >= 0 && pos < n) {
      if constexpr (!kB) {
        const unsigned d32 = (unsigned)__cvta_generic_to_shared(dst);
        cp_async4(d32, reinterpret_cast<const float*>(u) + row + pos);
        cp_async4(d32 + 4, reinterpret_cast<const float*>(v) + row + pos);
      } else {
        *dst = make_float2(to_f32(u[row + pos]), to_f32(v[row + pos]));
      }
    } else {
      *dst = make_float2(0.0f, 0.0f);
    }
  }
  if (threadIdx.x <= wpb)                      // the pads between windows
    uv[acq + threadIdx.x * (win + 1)] = make_float2(0.0f, 0.0f);
  asm volatile("cp.async.commit_group;\n" ::);

  // Every warp runs whole and in step (all shuffles take the full mask):
  // a window beyond the row runs on zeros and writes nothing.
  const int wl = threadIdx.x / kLanes;         // window within the block
  const int sub = threadIdx.x % kLanes;
  const int w = w0 + wl;
  const bool live_chain = w < n_w;
  const int d = sub >> 2;                      // 0 alpha, 1 beta
  const int q = sub & 3;
  const unsigned all = 0xffffffffu;
  const int lane0 = (threadIdx.x & 31) & ~3;   // this direction's q = 0
  // combine wiring (the same in both phases): lanes 0 and 1 end up with the
  // bit-0 maxima, lanes 2 and 3 with the bit-1 maxima, of code class 0 on
  // lanes 0, 3 and 1 on lanes 1, 2
  const bool keeps1 = q >= 2;
  const int mcode = keeps1 ? 3 - (q == 3 ? 0 : 1) : (q == 0 ? 0 : 1);
  const unsigned comb_vsign = inner_sign(mcode), comb_sign = outer_sign(mcode);

  const long long chain = (long long)cb * n_w + (live_chain ? w : 0);
  const float* init = (d ? b_init : a_init) + chain * 8;
  float* nii = (d ? b_nii : a_nii) + chain * 8;
  T* mine = store + wl * chain_stride + d * dir_stride;
  T* theirs = store + wl * chain_stride + (1 - d) * dir_stride;
  const int base = p0 + wl * win;              // first position of the window

  // state index of register r of pair k in this direction
  auto state = [&](int k, int r) { return d ? k + 4 * r : 2 * k + r; };

  // The beta sweep's dead positions (beyond n) are its steps t < t_pin.
  // Pinned, they are steps under the pin's gammas; frozen, no steps: the
  // chain then holds the phase of step t_pin across them.
  const int t_pin = d ? win - (n - base) : 0;
  const int skip = freeze ? max(t_pin, 0) : 0;

  // 1. acquisition runs over the live positions only (a dead one is a
  // no-op): alpha of window 0 has none; beta skips the positions beyond n.
  // The main sweep starts in phase 0 (phase skip & 1, frozen), so `live`
  // steps start in phase (live + skip) & 1.
  int first = 0;
  if (d == 0) {
    if (w == 0) first = acq;
  } else {
    first = min(max(base + win + acq - n, 0), acq);
  }
  int phase = (acq - first + skip) & 1;
  float r0 = 0.0f, r1 = 0.0f;
  if (live_chain) {
    const int k = phase ? swap2(q) : q;        // the phase's pair
    r0 = rnd<kB>(init[state(k, 0)]);
    r1 = rnd<kB>(init[state(k, 1)]);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  const Phase ph0 = phases[0][sub], ph1 = phases[1][sub];

  // One trellis step of the pair under its (signed) gamma g, in two parts so
  // that a caller can put other work into the shuffle's shadow: `butterfly`
  // leaves the new pair in (lo, hi) and returns the register to send across
  // lane bit p.swap; `exchange` takes what came back.
  float lo, hi;
  auto butterfly = [&](const Phase& p, float g) {
    lo = fmaxf(rnd<kB>(r0 + g), rnd<kB>(r1 - g));
    hi = fmaxf(rnd<kB>(r0 - g), rnd<kB>(r1 + g));
    return (q & p.swap) ? lo : hi;
  };
  auto exchange = [&](const Phase& p, float got) {
    const bool bit = q & p.swap;
    r0 = bit ? got : lo;
    r1 = bit ? hi : got;
  };
  auto step_gamma = [&](const Phase& p, float2 x, bool pin) {
    float g = gamma_m<kB>(x, p.vsign, 0u);
    if (pin) g = HALF_PIN;
    return with_sign(g, p.sign);
  };
  // bf16: after main-sweep step t, every `period` steps, x -= x[0]
  auto renorm = [&](int t) {
    if (kB && (t + 1) % period == 0) {
      const float s0 = __shfl_sync(all, r0, lane0);
      r0 = rnd<kB>(r0 - s0);
      r1 = rnd<kB>(r1 - s0);
    }
  };

  const float2* uacq = uv + (d ? wl * win + win + acq - 1 : wl * win - acq) +
                       acq + wl + 2 * d;       // first acquisition position
  for (int t = 0; t < acq; ++t) {
    const Phase p = phase ? ph1 : ph0;         // a copy: both stay registers
    const float send = butterfly(p, step_gamma(p, uacq[d ? -t : t], false));
    const float got = __shfl_xor_sync(all, send, p.swap);
    if (t >= first) {                          // a dead position: no step
      exchange(p, got);
      phase ^= 1;
    }
  }

  // The window's slab.  A warp issues in order, so what a step needs is
  // asked for early: the inputs are read two steps ahead (xp runs along this
  // direction's positions, forwards for alpha and backwards for beta) and
  // the gamma of the next step is formed while this step's shuffle is under
  // way.
  const float2* uwin = uv + wl * win + acq + wl + 1;
  const int xs = d ? -1 : 1;
  const float2* xp = uwin + (d ? win - 1 : 0);
  const bool pinned = !freeze;
  float g = step_gamma(ph0, xp[0], pinned && 0 < t_pin);
  float2 xn = xp[xs];
  xp += 2 * xs;

  // 2. store phase: the pre-step pair of step t goes to slot t, at its
  // butterfly's place (sp0 and sp1: where this lane's pair goes in phase 0
  // and in phase 1)
  T* sp0 = mine + 2 * ph0.pair;
  T* sp1 = mine + 8 + 2 * ph1.pair;
  auto store_step = [&](const Phase& p, const Phase& p_next, T* sp,
                        int t) {
    const float2 xnn = *xp;
    store2(sp, r0, r1);
    const float got = __shfl_xor_sync(all, butterfly(p, g), p.swap);
    g = step_gamma(p_next, xn, pinned && t + 1 < t_pin);
    if (t >= skip) exchange(p, got);
    renorm(t);
    xn = xnn;
    xp += xs;
  };
  for (int t = 0; t < half; t += 2) {
    store_step(ph0, ph1, sp0, t);
    store_step(ph1, ph0, sp1, t + 1);
    sp0 += 16;
    sp1 += 16;
  }
  __syncwarp();                                // the other direction's stores

  // 3. combine phase: the opposite direction's slot j = win-1-t holds the
  // pair this lane's position combines with.  With (x, y) the alpha pair
  // and (p, q) the beta pair of a butterfly, P = max(x + p, y + q) and
  // Q = max(x + q, y + p) are its maxima over the two codes.  The fold to
  // L is three dependent shuffles; it runs as a pipeline, one stage per
  // step, so that a step issues its four shuffles (the trellis step's and
  // one of each stage) back to back and waits for them once:
  //   A (step t):   lanes q and q ^ 3 share their codes; one keeps the
  //                 bit-0 maximum, the other the bit-1 maximum; add the
  //                 code's gamma;
  //   B (step t-1): across q ^ 1 to l0 (lanes 0, 1) or l1 (lanes 2, 3);
  //   C (step t-2): l1 comes across q ^ 3; lane 0 writes l0 - l1 into the
  //                 slot that step t-2 consumed.
  // The loop runs two steps past the window to drain the pipeline; what
  // the stages carry before they fill, and the steps past the window, is
  // never written (their reads stay inside the block's shared memory).
  // op0 and op1 walk down the opposite store at this lane's pair of phase 0
  // and of phase 1; lp walks down it two slots behind, where L goes.  The
  // combine sums in f32 whatever the metric type.
  const T* op0 = theirs + (half - 2) * 8 + 2 * ph0.pair;       // step half+1
  const T* op1 = theirs + (half - 2) * 8 + 2 * ph1.pair;
  LSlot<T>* lp =                               // the slot of step t-2
      reinterpret_cast<LSlot<T>*>(theirs + (half + 1) * 8);
  float2 o = load2(op0 + 8);                   // step half
  float ga = gamma_of(uwin[d ? half - 1 : half], comb_vsign, comb_sign);
  float in_b = 0.0f, in_c = 0.0f;              // what stages B and C take
  const int t_nii = win - acq;
  float nii0 = 0.0f, nii1 = 0.0f;              // the pair before step t_nii
  auto combine_step = [&](const Phase& p, const Phase& p_next,
                          const T* op_next, int t) {
    const float2 xnn = *xp;
    const float2 o_next = load2(op_next);
    if (t == t_nii) {
      nii0 = r0;
      nii1 = r1;
    }
    const float pm = fmaxf(r0 + o.x, r1 + o.y);
    const float qm = fmaxf(r0 + o.y, r1 + o.x);
    const float bit0 = p.bit0_is_p ? pm : qm;
    const float bit1 = p.bit0_is_p ? qm : pm;
    const float got_s = __shfl_xor_sync(all, butterfly(p, g), p.swap);
    const float got_a = __shfl_xor_sync(all, keeps1 ? bit0 : bit1, 3);
    const float got_b = __shfl_xor_sync(all, in_b, 1);
    const float got_c = __shfl_xor_sync(all, in_c, 3);
    g = step_gamma(p_next, xn, pinned && t + 1 < t_pin);
    const float ga_next = gamma_of(xn, comb_vsign, comb_sign);
    if (q == 0 && t >= half + 2) *lp = in_c - got_c;
    in_c = fmaxf(in_b, got_b);
    in_b = fmaxf(keeps1 ? bit1 : bit0, got_a) + ga;
    if (t >= skip) exchange(p, got_s);
    if (t < win) renorm(t);
    ga = ga_next;
    xn = xnn;
    o = o_next;
    xp += xs;
    lp -= 8;
  };
  for (int t = half; t < win + 2; t += 2) {
    combine_step(ph0, ph1, op1, t);            // reads ahead for step t+1
    combine_step(ph1, ph0, op0 - 8, t + 1);    // ... and for step t+2
    op0 -= 16;
    op1 -= 16;
  }
  if (live_chain) {
    // the pair before step t_nii belongs to that step's phase, or to step
    // t_pin's while a frozen chain holds it
    const int held = t_nii < skip ? skip : t_nii;
    const int k = (held & 1) ? ph1.pair : ph0.pair;
    nii[state(k, 0)] = nii0;
    nii[state(k, 1)] = nii1;
  }
  __syncthreads();

  // L of position t of a window: t < half in the alpha store's slot t, else
  // in the beta store's slot win-1-t
  for (int wl2 = 0; wl2 < wpb; ++wl2) {
    const T* st = store + wl2 * chain_stride;
    for (int t = threadIdx.x; t < win; t += blockDim.x) {
      const int pos = p0 + wl2 * win + t;
      const int slot = t < half ? t : win - 1 - t;
      if (pos < n)
        l_out[row + pos] = st[(t < half ? 0 : dir_stride) + slot * 8];
    }
  }
}

}  // namespace

// Shared memory of a block of wpb windows, bytes: the (u, v) slab in f32
// and the stores in T.
template <typename T>
static size_t turbo_smem_bytes(int win, int acq, int wpb) {
  const size_t slab_slots = (size_t)wpb * win + 2 * acq + wpb + 1;
  const size_t chain = 2 * ((size_t)(win / 2) * 8 + 8);
  return sizeof(float) * 2 * slab_slots + sizeof(T) * wpb * chain;
}

template <typename T>
static int launch(const void* u, const void* v, const float* a_init,
                  const float* b_init, void* l_out, float* a_nii,
                  float* b_nii, int c, int n, int n_w, int win, int acq,
                  int wpb, int freeze, cudaStream_t stream) {
  const size_t smem = turbo_smem_bytes<T>(win, acq, wpb);
  auto kernel = turbo_half_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const int blocks_per_row = (n_w + wpb - 1) / wpb;
  const long long blocks = (long long)c * blocks_per_row;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, wpb * kLanes, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(v), a_init, b_init,
      static_cast<T*>(l_out), a_nii, b_nii, n, n_w, win, acq, wpb,
      blocks_per_row, freeze);
  return (int)cudaGetLastError();
}

// u, v: (c, n) in the metric type (f32, or bf16 with bf16 = 1);
// a_init, b_init: (c, n_w, 8) f32 (already pinned); l_out: (c, n) in the
// metric type; a_nii, b_nii: (c, n_w, 8) f32 raw exports; wpb: windows per
// block (8 * wpb threads); bf16: 1 runs the bf16 trellis; freeze: 1 keeps
// the old beta at dead positions instead of pinning them.  Returns
// cudaGetLastError.
extern "C" int lteax_turbo_half(const void* u, const void* v,
                                const float* a_init, const float* b_init,
                                void* l_out, float* a_nii, float* b_nii,
                                int c, int n, int n_w, int win, int acq,
                                int wpb, int bf16, int freeze,
                                cudaStream_t stream) {
  if (win % 4 != 0 || acq <= 0 || acq > win / 2 || n_w * win < n ||
      (n_w - 1) * win >= n || wpb <= 0 || wpb * kLanes > 1024 ||
      (wpb * kLanes) % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (c <= 0) return 0;
  if (bf16)
    return launch<__nv_bfloat16>(u, v, a_init, b_init, l_out, a_nii, b_nii,
                                 c, n, n_w, win, acq, wpb, freeze, stream);
  return launch<float>(u, v, a_init, b_init, l_out, a_nii, b_nii, c, n, n_w,
                       win, acq, wpb, freeze, stream);
}
