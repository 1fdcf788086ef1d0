// Max-log-MAP turbo half-iteration, resident in shared memory: a block owns
// W consecutive windows of one codeblock (two codeblocks in the bf16 form),
// 8 lanes carry each window's chain.
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
// at C = 3328, n = 5827), but it takes ~6x that.  A chain is acq + win
// dependent steps, its win/2 x 8 alpha and beta stores are 4 KB, and 227 KB
// of shared memory hold ~40 chains an SM: ten warps, 2.5 a scheduler, each
// issuing in order.  Its trellis loops' instructions (their SASS, counted
// by bench/turbo_variants.py --sass), issued at one a clock by every
// scheduler, would take about half its time; the other half the
// schedulers wait, for what a step waits on (a shuffle, a shared-memory
// load, dependent f32 operations) with too few warps to cover it, and for
// the work outside the loops (staging, set-up, the write-out).  So both
// count: the instructions a chain executes and what each step waits for.
// The design:
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
// The freeze (pinpad=False): a dead position of the beta main sweep keeps
// the old beta, so the step is skipped as the acquisition skips one.  The
// dead steps are the first t_pin of the last window's sweep, so its chain
// starts in the phase of step t_pin and holds it across them.  (bf16's
// blend m*new + (1-m)*old keeps the old value too, up to the sign of a
// zero, which no comparison sees.)
//
// The bf16 trellis (the reference's "bf16" and "bf16_f32store", whose
// stores hold the same bf16 values) is a kernel of its own,
// turbo_half_bf16_kernel, on the same lane layout and wiring.  Every metric
// operation rounds to bf16: u + v and its halving, each ACS add, the
// renormalisation x -= x[0] of the main sweeps every `period` steps; the
// combine sums the bf16 metrics in f32 and L rounds once.
// What bounds it on an H100: the same walk and the same ten warps an SM
// (21 KB a block of four windows), and again its trellis loops'
// instructions at one a clock a scheduler are about half its time
// (turbo_variants --sass).  The f32 kernel's rounding to bf16 put three
// dependent instructions on each metric operation, and the design cuts
// both what a chain executes and what its steps wait for:
//   - native bf16x2 arithmetic, two chains a lane: a register holds one
//     metric of the same window of two codeblocks (2i, 2i+1) in its two
//     halves, and the ACS runs as add.rn / sub.rn / max on bf16x2 and the
//     gamma as one fma.rn (u + v*(+-1)) and one mul.rn by +-0.5 (the
//     signs ride on the constants: negation is exact, rounding to nearest
//     symmetric): one instruction where rounding an f32 result costs
//     three, and each instruction, shuffle and store serves both chains.
//     The two halves share K, the window and its phase, so the skips, pins
//     and phases are equal and control flow stays uniform; with an odd C
//     the high half of the last pair runs on zeros and writes nothing.  One
//     correctly rounded bf16 operation equals the f32 operation rounded to
//     bf16 (24 >= 2 * 8 + 2 bits), which is what torch's bf16 does, so the
//     result is the plain version's bit for bit.  The combine widens its
//     operands (the gamma's signs put on as they widen) and sums in f32,
//     two chains a lane; its fold takes two shuffles a stage;
//   - the renormalisation without a shuffle of its own on the chain: the
//     new state 0 is lane 0's own `lo` before the exchange, so its
//     broadcast goes out back to back with the exchange, not after it, and
//     the step waits for one shuffle, not two (in a frozen step, lane 0's
//     held state 0).  Renormalisation falls on odd steps only, a literal
//     at every call: no per-step division;
//   - a bf16 slab: the block's u and v of both codeblocks are copied by
//     cp.async as four raw planes (a row starts at any bf16 address, n may
//     be odd: a plane starts one slot late where its row is not 4-byte
//     aligned, so every 4-byte word copies as one; the word past the row's
//     end copies 2 bytes and fills zeros, the word before its start is
//     loaded), into the store region, which is free until the store phase.
//     One pass re-packs them as (u, v) of both codeblocks, 8 bytes a
//     position (4 a position and codeblock, half the f32 slab's), with the
//     same padding slot per window.  A step then reads one 8-byte word.
// The levers are template flags, so that each one's time can be taken
// against the others (lteax_turbo_half_bf16_variant); the decoders launch
// all three.  The second and third leave the trellis loops' instructions
// as they are (within 4%) and take waits off: a shuffle off each
// renormalising step's chain, the memory latency of a loop of 2-byte loads
// off the staging.  At C = 3328, n = 5827 on an H100 SXM at 700 W: lever 1
// 0.38 ms, 2 0.36, 3 0.29; the f32 form 0.44.
//
// The 8-state wiring is lteax.phy.fec.turbo._unrolled_wiring written out as
// the two tables below (the tests parse them back and compare): a row of
// FWD is (p0, p1, g0, g1) of a'[s'] = max(a[p0] + g[g0], a[p1] + g[g1]), a
// row of BWD is (n0, n1, g0, g1) of b'[s] = max(b[n0] + g[g0], b[n1] +
// g[g1]).  The kernels read their wiring from them, and a static_assert
// holds them to the butterfly structure the lane layout needs.

#include <cuda_runtime.h>
#include <cstdint>

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

// a pair of metrics in a store
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
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

// The f32 trellis.  freeze: the beta main sweep keeps the old beta at dead
// positions instead of pinning them.
__global__ void turbo_half_kernel(const float* __restrict__ u,
                                  const float* __restrict__ v,
                                  const float* __restrict__ a_init,
                                  const float* __restrict__ b_init,
                                  float* __restrict__ l_out,
                                  float* __restrict__ a_nii,
                                  float* __restrict__ b_nii,
                                  int n, int n_w, int win, int acq, int wpb,
                                  int blocks_per_row, int freeze) {
  extern __shared__ float smem[];
  const int half = win / 2;
  const int dir_stride = half * 8 + 8;         // one direction's store + pad
  const int chain_stride = 2 * dir_stride;
  const int slab = wpb * win + 2 * acq;        // positions staged
  const int slab_slots = slab + wpb + 1;
  float2* uv = reinterpret_cast<float2*>(smem);   // (u, v) per position
  float* store = smem + 2 * slab_slots;

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
  // memory's latency per turn).
  for (int i = threadIdx.x; i < slab; i += blockDim.x) {
    const int rel = i - acq;
    const int pos = p0 + rel;
    float2* dst = uv + slab_index(rel, win, acq);
    if (pos >= 0 && pos < n) {
      const unsigned d32 = (unsigned)__cvta_generic_to_shared(dst);
      cp_async4(d32, u + row + pos);
      cp_async4(d32 + 4, v + row + pos);
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
  // combine wiring (the same in both phases): lanes 0 and 1 end up with the
  // bit-0 maxima, lanes 2 and 3 with the bit-1 maxima, of code class 0 on
  // lanes 0, 3 and 1 on lanes 1, 2
  const bool keeps1 = q >= 2;
  const int mcode = keeps1 ? 3 - (q == 3 ? 0 : 1) : (q == 0 ? 0 : 1);
  const unsigned comb_vsign = inner_sign(mcode), comb_sign = outer_sign(mcode);

  const long long chain = (long long)cb * n_w + (live_chain ? w : 0);
  const float* init = (d ? b_init : a_init) + chain * 8;
  float* nii = (d ? b_nii : a_nii) + chain * 8;
  float* mine = store + wl * chain_stride + d * dir_stride;
  float* theirs = store + wl * chain_stride + (1 - d) * dir_stride;
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
    r0 = init[state(k, 0)];
    r1 = init[state(k, 1)];
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
    lo = fmaxf(r0 + g, r1 - g);
    hi = fmaxf(r0 - g, r1 + g);
    return (q & p.swap) ? lo : hi;
  };
  auto exchange = [&](const Phase& p, float got) {
    const bool bit = q & p.swap;
    r0 = bit ? got : lo;
    r1 = bit ? hi : got;
  };
  auto step_gamma = [&](const Phase& p, float2 x, bool pin) {
    float g = gamma_of(x, p.vsign, 0u);
    if (pin) g = HALF_PIN;
    return with_sign(g, p.sign);
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
  float* sp0 = mine + 2 * ph0.pair;
  float* sp1 = mine + 8 + 2 * ph1.pair;
  auto store_step = [&](const Phase& p, const Phase& p_next, float* sp,
                        int t) {
    const float2 xnn = *xp;
    store2(sp, r0, r1);
    const float got = __shfl_xor_sync(all, butterfly(p, g), p.swap);
    g = step_gamma(p_next, xn, pinned && t + 1 < t_pin);
    if (t >= skip) exchange(p, got);
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
  // and of phase 1; lp walks down it two slots behind, where L goes.
  const float* op0 = theirs + (half - 2) * 8 + 2 * ph0.pair;   // step half+1
  const float* op1 = theirs + (half - 2) * 8 + 2 * ph1.pair;
  float* lp = theirs + (half + 1) * 8;         // the slot of step t-2
  float2 o = load2(op0 + 8);                   // step half
  float ga = gamma_of(uwin[d ? half - 1 : half], comb_vsign, comb_sign);
  float in_b = 0.0f, in_c = 0.0f;              // what stages B and C take
  const int t_nii = win - acq;
  float nii0 = 0.0f, nii1 = 0.0f;              // the pair before step t_nii
  auto combine_step = [&](const Phase& p, const Phase& p_next,
                          const float* op_next, int t) {
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
    const float* st = store + wl2 * chain_stride;
    for (int t = threadIdx.x; t < win; t += blockDim.x) {
      const int pos = p0 + wl2 * win + t;
      const int slot = t < half ? t : win - 1 - t;
      if (pos < n)
        l_out[row + pos] = st[(t < half ? 0 : dir_stride) + slot * 8];
    }
  }
}

// ---- the bf16 trellis: two codeblocks a lane, native bf16x2 arithmetic --

// A bf16x2 register holds one metric of codeblock 2i (low half) and of
// codeblock 2i+1 (high half).  Each operation is one correctly rounded
// bf16 operation a half (sm_90: add, sub and mul with .rn, max exact).
__device__ __forceinline__ unsigned add2(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned sub2(unsigned a, unsigned b) {
  unsigned d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned mul2(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned fma2(unsigned a, unsigned b, unsigned c) {
  unsigned d;   // a * b + c, rounded once
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ unsigned max2(unsigned a, unsigned b) {
  unsigned d;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// each half widened to f32 (exact), and two f32 rounded into one register
__device__ __forceinline__ float lo_f(unsigned x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float hi_f(unsigned x) {
  return __uint_as_float(x & 0xffff0000u);
}
// ... with a sign bit put on (the low half shifted up by the multiply, the
// sign added: one instruction each)
__device__ __forceinline__ float lo_f(unsigned x, unsigned sign) {
  return __uint_as_float(x * 0x10000u + sign);
}
__device__ __forceinline__ float hi_f(unsigned x, unsigned sign) {
  return __uint_as_float((x & 0xffff0000u) ^ sign);
}
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  unsigned d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

constexpr unsigned kOne2 = 0x3f803f80u;        // (1, 1)
constexpr unsigned kHalf2 = 0x3f003f00u;       // (0.5, 0.5)
constexpr unsigned kHalfPin2 = 0x43804380u;    // (HALF_PIN, HALF_PIN)
constexpr unsigned kSign2 = 0x80008000u;       // both halves' sign bits

// A Phase in bf16x2 constants: the step's gamma is (v * vmul + u) * half,
// vmul = +-1 and half = +-0.5 carrying the inner and the outer sign (a
// negation is exact, and rounding to nearest is symmetric, so this is
// +-((u +- v) rounded * 0.5) rounded), or `pin` at a pinned dead position;
// and the combine's choice: a lane sends Q = max(x + q, y + p) across the
// fold's first stage and keeps P, or the other way round.
struct Phase2 {
  int pair;
  unsigned vmul, half, pin;
  int swap;
  bool sends_q;
};
__device__ __forceinline__ Phase2 phase2(const Phase& p, bool keeps1) {
  const unsigned sign = p.sign ? kSign2 : 0u;
  // the f32 kernel sends keeps1 ? bit0 : bit1, bit0 being P where
  // bit0_is_p
  return {p.pair, kOne2 ^ (p.vsign ? kSign2 : 0u), kHalf2 ^ sign,
          kHalfPin2 ^ sign, p.swap, keeps1 != (bool)p.bit0_is_p};
}

// 4 bytes (src_bytes of them read, the rest zero) into shared memory
__device__ __forceinline__ void cp_async4_zfill(unsigned dst, const void* src,
                                                int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

// One raw plane of a block's slab, staged by cp.async: slot j holds
// position p0 - acq + j - shift of row `src`, zero outside [0, n) (and
// everywhere where the row is not `live`); returns shift, 1 where the row
// starts at an odd bf16 address, so that every 4-byte word of the plane is
// a 4-byte word of the row.  `plane` is even.
__device__ __forceinline__ int stage_plane(uint16_t* dst, int plane,
                                           const uint16_t* src, bool live,
                                           int p0, int acq, int n) {
  const int shift =
      live ? (int)(((reinterpret_cast<uintptr_t>(src) >> 1) + acq) & 1) : 0;
  for (int wi = threadIdx.x; wi < plane / 2; wi += blockDim.x) {
    const int pa = p0 - acq - shift + 2 * wi;    // slot 2wi's position
    const bool la = live && pa >= 0 && pa < n;
    const bool lb = live && pa + 1 >= 0 && pa + 1 < n;
    const unsigned d32 = (unsigned)__cvta_generic_to_shared(dst + 2 * wi);
    if (la)
      cp_async4_zfill(d32, src + pa, lb ? 4 : 2);
    else
      *reinterpret_cast<unsigned*>(dst + 2 * wi) =
          lb ? (unsigned)src[pa + 1] << 16 : 0u;
  }
  return shift;
}

// kFold: the renormalisation's broadcast rides beside the exchange (lever
// 2); kAsync: the slab is staged by cp.async (lever 3); kFreeze: the beta
// main sweep keeps the old beta at dead positions instead of pinning them.
// u, v, l_out: bf16 bits.  A block owns windows w0 .. w0+wpb-1 of
// codeblocks 2i and 2i+1.
template <bool kFold, bool kAsync, bool kFreeze>
__global__ void turbo_half_bf16_kernel(const uint16_t* __restrict__ u,
                                       const uint16_t* __restrict__ v,
                                       const float* __restrict__ a_init,
                                       const float* __restrict__ b_init,
                                       uint16_t* __restrict__ l_out,
                                       float* __restrict__ a_nii,
                                       float* __restrict__ b_nii, int c,
                                       int n, int n_w, int win, int acq,
                                       int wpb, int blocks_per_row) {
  extern __shared__ uint2 smem2[];
  const int half = win / 2;
  const int period = half % 4 == 0 ? 4 : 2;    // renormalisation
  const int dir_stride = half * 8 + 8;         // one direction's store + pad
  const int chain_stride = 2 * dir_stride;
  const int slab = wpb * win + 2 * acq;        // positions staged
  const int slab_slots = slab + wpb + 1;
  uint2* uv = smem2;                           // (u, v), both codeblocks
  unsigned* store = reinterpret_cast<unsigned*>(smem2 + slab_slots);

  const int pr = blockIdx.x / blocks_per_row;  // codeblocks 2pr and 2pr+1
  const bool has1 = 2 * pr + 1 < c;
  const int w0 = (blockIdx.x % blocks_per_row) * wpb;
  const long long row0 = 2LL * pr * n, row1 = row0 + n;
  const int p0 = w0 * win;

  __shared__ Phase phases[2][kLanes];
  if (threadIdx.x < 2 * kLanes)
    phases[threadIdx.x >> 3][threadIdx.x & 7] = make_phase(
        (threadIdx.x >> 2) & 1, threadIdx.x & 3, threadIdx.x >> 3);

  // The slab, zero outside [0, n), in the pad slots and in a missing
  // codeblock's half.
  const int plane = slab + 2;                  // a raw plane, in bf16 slots
  int shift[4];                                // its late start (0 or 1)
  if constexpr (kAsync) {
    // planes u0, v0, u1, v1 (a missing codeblock's two all zero)
    uint16_t* raw = reinterpret_cast<uint16_t*>(store);
#pragma unroll
    for (int x = 0; x < 4; ++x)
      shift[x] = stage_plane(raw + x * plane, plane,
                             (x & 1 ? v : u) + (x < 2 ? row0 : row1),
                             x < 2 || has1, p0, acq, n);
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    // a loop of 2-byte loads
    for (int i = threadIdx.x; i < slab; i += blockDim.x) {
      const int pos = p0 + i - acq;
      uint2 x = make_uint2(0u, 0u);
      if (pos >= 0 && pos < n) {
        x.x = u[row0 + pos] | (has1 ? (unsigned)u[row1 + pos] << 16 : 0u);
        x.y = v[row0 + pos] | (has1 ? (unsigned)v[row1 + pos] << 16 : 0u);
      }
      uv[slab_index(i - acq, win, acq)] = x;
    }
  }
  if (threadIdx.x <= wpb)                      // the pads between windows
    uv[acq + threadIdx.x * (win + 1)] = make_uint2(0u, 0u);

  const int wl = threadIdx.x / kLanes;         // window within the block
  const int sub = threadIdx.x % kLanes;
  const int w = w0 + wl;
  const bool live_chain = w < n_w;
  const int d = sub >> 2;                      // 0 alpha, 1 beta
  const int q = sub & 3;
  const unsigned all = 0xffffffffu;
  // the combine's wiring, as the f32 kernel's
  const bool keeps1 = q >= 2;
  const int mcode = keeps1 ? 3 - (q == 3 ? 0 : 1) : (q == 0 ? 0 : 1);
  // its gamma +-0.5 * (u +- v) in f32 as 0.5 * (+-u +- v): both signs put
  // on as the operands widen
  const unsigned comb_usign = outer_sign(mcode);
  const unsigned comb_vsign = inner_sign(mcode) ^ comb_usign;

  const long long chain0 = 2LL * pr * n_w + (live_chain ? w : 0);
  const long long chain1 = has1 ? chain0 + n_w : chain0;
  const float* init = d ? b_init : a_init;
  float* nii = d ? b_nii : a_nii;
  unsigned* mine = store + wl * chain_stride + d * dir_stride;
  unsigned* theirs = store + wl * chain_stride + (1 - d) * dir_stride;
  const int base = p0 + wl * win;

  auto state = [&](int k, int r) { return d ? k + 4 * r : 2 * k + r; };
  const int t_pin = d ? win - (n - base) : 0;
  const int skip = kFreeze ? max(t_pin, 0) : 0;
  int first = 0;
  if (d == 0) {
    if (w == 0) first = acq;
  } else {
    first = min(max(base + win + acq - n, 0), acq);
  }
  unsigned r0 = 0u, r1 = 0u;
  if (live_chain) {                            // the inits round to bf16
    const int k = (acq - first + skip) & 1 ? swap2(q) : q;
    const float* i0 = init + chain0 * 8;
    const float* i1 = init + chain1 * 8;
    r0 = pack2(i0[state(k, 0)], has1 ? i1[state(k, 0)] : 0.0f);
    r1 = pack2(i0[state(k, 1)], has1 ? i1[state(k, 1)] : 0.0f);
  }
  if constexpr (kAsync) {
    // re-pack the raw planes into the slab; the store region is then free
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    const uint16_t* raw = reinterpret_cast<const uint16_t*>(store);
    for (int i = threadIdx.x; i < slab; i += blockDim.x)
      uv[slab_index(i - acq, win, acq)] = make_uint2(
          raw[i + shift[0]] | (unsigned)raw[2 * plane + i + shift[2]] << 16,
          raw[plane + i + shift[1]] |
              (unsigned)raw[3 * plane + i + shift[3]] << 16);
  }
  __syncthreads();
  const Phase2 ph0 = phase2(phases[0][sub], keeps1);
  const Phase2 ph1 = phase2(phases[1][sub], keeps1);

  unsigned lo, hi;
  auto butterfly = [&](const Phase2& p, unsigned g) {
    lo = max2(add2(r0, g), sub2(r1, g));
    hi = max2(sub2(r0, g), add2(r1, g));
    return (q & p.swap) ? lo : hi;
  };
  auto exchange = [&](const Phase2& p, unsigned got) {
    const bool bit = q & p.swap;
    r0 = bit ? got : lo;
    r1 = bit ? hi : got;
  };
  // (u + v) rounded, then its halving rounded, as torch's bf16 does
  auto step_gamma = [&](const Phase2& p, uint2 x, bool pin) {
    return pin ? p.pin : mul2(fma2(x.y, p.vmul, x.x), p.half);
  };
  // The main sweeps' renormalisation after step t, every `period` steps
  // (2 or 4, so only after odd steps: `odd` is a literal at every call):
  // x -= x[0], state 0 being r0 of the direction's lane 0 (q = 0: the
  // first of its 4 lanes).  After the step that is lane 0's own lo (its
  // held r0 in a frozen step), so with kFold its broadcast is asked for
  // beside the exchange (`early`), else after it (`late`).
  auto renorms = [&](bool odd, int t) {
    return odd && ((t + 1) & (period - 1)) == 0;
  };
  auto renorm_early = [&](bool rn, int t) {
    unsigned s0 = 0u;
    if (kFold && rn) s0 = __shfl_sync(all, t >= skip ? lo : r0, 0, 4);
    return s0;
  };
  auto renorm_late = [&](bool rn, unsigned s0) {
    if (rn) {
      if (!kFold) s0 = __shfl_sync(all, r0, 0, 4);
      r0 = sub2(r0, s0);
      r1 = sub2(r1, s0);
    }
  };

  // A live acquisition step t runs in phase (acq + skip + t) & 1 (a dead
  // one, t < first, is dropped), so the loop takes two fixed phases.
  const uint2* uacq = uv + (d ? wl * win + win + acq - 1 : wl * win - acq) +
                      acq + wl + 2 * d;
  const bool odd_start = (acq + skip) & 1;
  const Phase2 pa = odd_start ? ph1 : ph0, pb = odd_start ? ph0 : ph1;
  auto acq_step = [&](const Phase2& p, int t) {
    const unsigned send =
        butterfly(p, step_gamma(p, uacq[d ? -t : t], false));
    const unsigned got = __shfl_xor_sync(all, send, p.swap);
    if (t >= first) exchange(p, got);
  };
  for (int t = 0; t < acq; t += 2) {
    acq_step(pa, t);
    if (t + 1 < acq) acq_step(pb, t + 1);
  }

  const uint2* uwin = uv + wl * win + acq + wl + 1;
  const int xs = d ? -1 : 1;
  const uint2* xp = uwin + (d ? win - 1 : 0);
  const bool pinned = !kFreeze;
  unsigned g = step_gamma(ph0, xp[0], pinned && 0 < t_pin);
  uint2 xn = xp[xs];
  xp += 2 * xs;

  unsigned* sp0 = mine + 2 * ph0.pair;
  unsigned* sp1 = mine + 8 + 2 * ph1.pair;
  auto store_step = [&](const Phase2& p, const Phase2& p_next, unsigned* sp,
                        int t, bool odd) {
    const uint2 xnn = *xp;
    *reinterpret_cast<uint2*>(sp) = make_uint2(r0, r1);
    const unsigned got = __shfl_xor_sync(all, butterfly(p, g), p.swap);
    const bool rn = renorms(odd, t);
    const unsigned s0 = renorm_early(rn, t);
    g = step_gamma(p_next, xn, pinned && t + 1 < t_pin);
    if (t >= skip) exchange(p, got);
    renorm_late(rn, s0);
    xn = xnn;
    xp += xs;
  };
  for (int t = 0; t < half; t += 2) {
    store_step(ph0, ph1, sp0, t, false);
    store_step(ph1, ph0, sp1, t + 1, true);
    sp0 += 16;
    sp1 += 16;
  }
  __syncwarp();

  // the combine, in f32 a codeblock (h = 0: low halves, 1: high halves),
  // pipelined as the f32 kernel's
  auto comb_gamma = [&](uint2 x) {
    return make_float2(
        0.5f * (lo_f(x.x, comb_usign) + lo_f(x.y, comb_vsign)),
        0.5f * (hi_f(x.x, comb_usign) + hi_f(x.y, comb_vsign)));
  };
  const unsigned* op0 = theirs + (half - 2) * 8 + 2 * ph0.pair;
  const unsigned* op1 = theirs + (half - 2) * 8 + 2 * ph1.pair;
  unsigned* lp = theirs + (half + 1) * 8;
  uint2 o = *reinterpret_cast<const uint2*>(op0 + 8);
  float2 ga = comb_gamma(uwin[d ? half - 1 : half]);
  float in_b0 = 0.0f, in_b1 = 0.0f, in_c0 = 0.0f, in_c1 = 0.0f;
  const int t_nii = win - acq;
  unsigned nii0 = 0u, nii1 = 0u;
  auto combine_step = [&](const Phase2& p, const Phase2& p_next,
                          const unsigned* op_next, int t, bool odd) {
    const uint2 xnn = *xp;
    const uint2 o_next = *reinterpret_cast<const uint2*>(op_next);
    if (t == t_nii) {
      nii0 = r0;
      nii1 = r1;
    }
    const float x0 = lo_f(r0), x1 = hi_f(r0), y0 = lo_f(r1), y1 = hi_f(r1);
    const float p0_ = lo_f(o.x), p1_ = hi_f(o.x);
    const float q0_ = lo_f(o.y), q1_ = hi_f(o.y);
    const float pm0 = fmaxf(x0 + p0_, y0 + q0_);
    const float qm0 = fmaxf(x0 + q0_, y0 + p0_);
    const float pm1 = fmaxf(x1 + p1_, y1 + q1_);
    const float qm1 = fmaxf(x1 + q1_, y1 + p1_);
    const float send0 = p.sends_q ? qm0 : pm0, keep0 = p.sends_q ? pm0 : qm0;
    const float send1 = p.sends_q ? qm1 : pm1, keep1 = p.sends_q ? pm1 : qm1;
    const unsigned got_s = __shfl_xor_sync(all, butterfly(p, g), p.swap);
    const bool rn = t < win && renorms(odd, t);
    const unsigned s0 = renorm_early(rn, t);
    const float got_a0 = __shfl_xor_sync(all, send0, 3);
    const float got_a1 = __shfl_xor_sync(all, send1, 3);
    const float got_b0 = __shfl_xor_sync(all, in_b0, 1);
    const float got_b1 = __shfl_xor_sync(all, in_b1, 1);
    const float got_c0 = __shfl_xor_sync(all, in_c0, 3);
    const float got_c1 = __shfl_xor_sync(all, in_c1, 3);
    g = step_gamma(p_next, xn, pinned && t + 1 < t_pin);
    const float2 ga_next = comb_gamma(xn);
    if (q == 0 && t >= half + 2) *lp = pack2(in_c0 - got_c0, in_c1 - got_c1);
    in_c0 = fmaxf(in_b0, got_b0);
    in_c1 = fmaxf(in_b1, got_b1);
    in_b0 = fmaxf(keep0, got_a0) + ga.x;
    in_b1 = fmaxf(keep1, got_a1) + ga.y;
    if (t >= skip) exchange(p, got_s);
    renorm_late(rn, s0);
    ga = ga_next;
    xn = xnn;
    o = o_next;
    xp += xs;
    lp -= 8;
  };
  for (int t = half; t < win + 2; t += 2) {
    combine_step(ph0, ph1, op1, t, false);
    combine_step(ph1, ph0, op0 - 8, t + 1, true);
    op0 -= 16;
    op1 -= 16;
  }
  if (live_chain) {
    const int held = t_nii < skip ? skip : t_nii;
    const int k = (held & 1) ? ph1.pair : ph0.pair;
    float* n0 = nii + chain0 * 8;
    n0[state(k, 0)] = lo_f(nii0);
    n0[state(k, 1)] = lo_f(nii1);
    if (has1) {
      float* n1 = nii + chain1 * 8;
      n1[state(k, 0)] = hi_f(nii0);
      n1[state(k, 1)] = hi_f(nii1);
    }
  }
  __syncthreads();

  for (int wl2 = 0; wl2 < wpb; ++wl2) {
    const unsigned* st = store + wl2 * chain_stride;
    for (int t = threadIdx.x; t < win; t += blockDim.x) {
      const int pos = p0 + wl2 * win + t;
      const int slot = t < half ? t : win - 1 - t;
      if (pos < n) {
        const unsigned x = st[(t < half ? 0 : dir_stride) + slot * 8];
        l_out[row0 + pos] = (uint16_t)x;
        if (has1) l_out[row1 + pos] = (uint16_t)(x >> 16);
      }
    }
  }
}

}  // namespace

// Shared memory of a block of wpb windows, bytes: the slab, 8 bytes a
// position (f32 (u, v); bf16 (u, v) of two codeblocks), and the stores,
// 4 bytes a metric (f32; a bf16 pair of two codeblocks).  The bf16
// kernel's raw planes fit in its stores.
static size_t turbo_smem_bytes(int win, int acq, int wpb) {
  const size_t slab_slots = (size_t)wpb * win + 2 * acq + wpb + 1;
  const size_t chain = 2 * ((size_t)(win / 2) * 8 + 8);
  return 8 * slab_slots + 4 * wpb * chain;
}

template <typename Kernel>
static int prepare(Kernel kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
}

static int launch_f32(const void* u, const void* v, const float* a_init,
                      const float* b_init, void* l_out, float* a_nii,
                      float* b_nii, int c, int n, int n_w, int win, int acq,
                      int wpb, int freeze, cudaStream_t stream) {
  const size_t smem = turbo_smem_bytes(win, acq, wpb);
  if (int e = prepare(turbo_half_kernel, smem)) return e;
  const int blocks_per_row = (n_w + wpb - 1) / wpb;
  const long long blocks = (long long)c * blocks_per_row;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  turbo_half_kernel<<<(unsigned)blocks, wpb * kLanes, smem, stream>>>(
      static_cast<const float*>(u), static_cast<const float*>(v), a_init,
      b_init, static_cast<float*>(l_out), a_nii, b_nii, n, n_w, win, acq,
      wpb, blocks_per_row, freeze);
  return (int)cudaGetLastError();
}

template <bool kFold, bool kAsync>
static int launch_bf16(const void* u, const void* v, const float* a_init,
                       const float* b_init, void* l_out, float* a_nii,
                       float* b_nii, int c, int n, int n_w, int win, int acq,
                       int wpb, int freeze, cudaStream_t stream) {
  const size_t smem = turbo_smem_bytes(win, acq, wpb);
  auto kernel = freeze ? turbo_half_bf16_kernel<kFold, kAsync, true>
                       : turbo_half_bf16_kernel<kFold, kAsync, false>;
  if (int e = prepare(kernel, smem)) return e;
  const int blocks_per_row = (n_w + wpb - 1) / wpb;
  const long long blocks = (long long)((c + 1) / 2) * blocks_per_row;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, wpb * kLanes, smem, stream>>>(
      static_cast<const uint16_t*>(u), static_cast<const uint16_t*>(v),
      a_init, b_init, static_cast<uint16_t*>(l_out), a_nii, b_nii, c, n, n_w,
      win, acq, wpb, blocks_per_row);
  return (int)cudaGetLastError();
}

static bool valid_args(int n, int n_w, int win, int acq, int wpb) {
  return !(win % 4 != 0 || acq <= 0 || acq > win / 2 || n_w * win < n ||
           (n_w - 1) * win >= n || wpb <= 0 || wpb * kLanes > 1024 ||
           (wpb * kLanes) % 32 != 0);
}

// u, v: (c, n) in the metric type (f32, or bf16 with bf16 = 1);
// a_init, b_init: (c, n_w, 8) f32 (already pinned); l_out: (c, n) in the
// metric type; a_nii, b_nii: (c, n_w, 8) f32 raw exports; wpb: windows per
// block (8 * wpb threads; in bf16 each window of two codeblocks); bf16: 1
// runs the bf16 trellis; freeze: 1 keeps the old beta at dead positions
// instead of pinning them.  Returns cudaGetLastError.
extern "C" int lteax_turbo_half(const void* u, const void* v,
                                const float* a_init, const float* b_init,
                                void* l_out, float* a_nii, float* b_nii,
                                int c, int n, int n_w, int win, int acq,
                                int wpb, int bf16, int freeze,
                                cudaStream_t stream) {
  if (!valid_args(n, n_w, win, acq, wpb)) return (int)cudaErrorInvalidValue;
  if (c <= 0) return 0;
  if (bf16)
    return launch_bf16<true, true>(u, v, a_init, b_init, l_out, a_nii, b_nii,
                                   c, n, n_w, win, acq, wpb, freeze, stream);
  return launch_f32(u, v, a_init, b_init, l_out, a_nii, b_nii, c, n, n_w,
                    win, acq, wpb, freeze, stream);
}

// The bf16 kernel's variants, for timing them against one another: after
// lever 1 (native bf16x2 arithmetic, two codeblocks a lane), 2 (+ the
// renormalisation's broadcast beside the exchange) or 3 (+ the slab staged
// by cp.async: the kernel lteax_turbo_half launches); arguments as
// lteax_turbo_half's with bf16 = 1.
extern "C" int lteax_turbo_half_bf16_variant(
    const void* u, const void* v, const float* a_init, const float* b_init,
    void* l_out, float* a_nii, float* b_nii, int c, int n, int n_w, int win,
    int acq, int wpb, int freeze, int variant, cudaStream_t stream) {
  if (!valid_args(n, n_w, win, acq, wpb) || variant < 1 || variant > 3)
    return (int)cudaErrorInvalidValue;
  if (c <= 0) return 0;
  auto launch = variant == 1   ? &launch_bf16<false, false>
                : variant == 2 ? &launch_bf16<true, false>
                               : &launch_bf16<true, true>;
  return launch(u, v, a_init, b_init, l_out, a_nii, b_nii, c, n, n_w, win,
                acq, wpb, freeze, stream);
}
