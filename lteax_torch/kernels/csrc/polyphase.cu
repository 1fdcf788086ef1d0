// Rational P/Q polyphase resampler of complex streams.
//
// Replaces the TPU Pallas kernel lteax/kernels/polyphase.py ::
// resample_poly_pallas.  On the TPU the P subfilters ran as shifted
// (F, Q) @ (Q, P) matmuls against a dense (K_in, P) frame weight that is
// 12/K_in non-zero.  Here output sample y[j*P + r] is the 12-tap FIR
//
//   y[j*P + r] = sum_t bank[(r*Q) mod P][t] * x[j*Q + off_r + T-1 - t],
//   off_r = floor(r*Q / P),
//
// which skips the weight's zeros.
//
// Bound.  46 operations (24 mul, 22 add) for 8*Q/P + 8 bytes per output:
// far below the card's 33.5 T/s f32 rate per byte of HBM, so memory
// bounds it.  At the scanner's shapes (192/125): (16, 400 000) moves
// 130 MB, 0.0387 ms at 3.35 TB/s; the scanner's own launch, one channel
// (1, 400 000), moves 8.1 MB, 0.0024 ms, and is latency, not bandwidth.
//
// The design streams the input once and the output once and keeps the rest
// off that path.  A FIR with one output per thread and loop turn (6x its
// bound on an H100) loses the time five ways; what this design does about
// each:
// 1. An integer division and a 64-bit modulo per output.  Here a thread
//    owns fixed items (frame slot s, phase r): their taps, input offset and
//    output index are computed once, before the tile loop; the loop has no
//    division and no 64-bit arithmetic but the tile's base pointers.
// 2. Scattered tap loads (32 phases a warp, a bank row each, every tap).
//    Here the taps of each item sit in registers for the whole launch.
// 3. No overlap of loads and compute.  Here a block walks tiles of F frames
//    in a persistent loop and stages tile i+1's input span by cp.async (16
//    bytes a copy) into the second of two shared buffers while it computes
//    tile i.  Neighbouring tiles overlap by K_in - Q samples of halo, read
//    again from device memory (L2), never exchanged between blocks.
// 4. Too few blocks at the scanner's one-channel launch (100 blocks on 132
//    SMs).  The launch plan (lteax_torch/kernels/polyphase.py ::
//    launch_plan) sizes tiles and grid from C, L and P/Q: at (1, 400 000)
//    192/125 it runs 533 blocks of one tile of 6 frames; at (16, 400 000)
//    800 blocks of four tiles of 16 frames.
// 5. The bank's upload per call: the wrapper keeps it on the device.
//
// Mapping.  A pass of the block computes S frames x P phases as items
// k = (g*R + m)*NT + thread, m < R (R items a thread, NT threads, phase
// group g = blockIdx.y): s = k / P, r = k mod P, live while k < S*P.  Items
// of neighbouring lanes are neighbouring phases, so their shared-memory
// reads are neighbouring samples and their stores neighbouring float2s.
// When P > R*NT the phases split over G groups of blocks (S = 1) that stage
// the same tiles.
//
// Alignment.  A tile's span starts at flat sample c*L + j0*Q, odd in half
// the tiles when Q or L is odd; the copy starts one sample earlier on an
// even (16-byte) boundary and the tile reads from `shift` on.  The last
// copy may run past the channel's end: what lies beyond it reads as zero
// (cp.async's src-size), though no live output reads it.
//
// Taps accumulate t = 0..T-1 in order, real and imaginary parts
// separately, as separate multiplies and adds; built with -fmad=false the
// kernel equals the plain torch version (lteax_torch/kernels/polyphase.py)
// bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 12;
constexpr int kMaxThreads = 512;

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

struct Tile {
  int c;          // channel
  int j0;         // first frame
  int nf;         // frames in the tile (the channel's last tile is ragged)
  long long g0;   // flat index of its first input sample, c*L + j0*Q
};

__device__ __forceinline__ Tile tile_at(int u, int tiles, int frames,
                                        int n_frames, int l, int q) {
  Tile t;
  t.c = u / tiles;
  t.j0 = (u - t.c * tiles) * frames;
  t.nf = min(frames, n_frames - t.j0);
  t.g0 = (long long)t.c * l + (long long)t.j0 * q;
  return t;
}

// Copy the tile's span x[g0, g0 + (nf-1)*Q + K_in) of the flat (C*L)
// stream to `buf`, from the even index at or below g0; bytes at or past
// the channel's end are zero-filled.
__device__ __forceinline__ void stage(const float2* x, float2* buf,
                                      const Tile& t, int l, int q,
                                      int k_in) {
  const long long ga = t.g0 & ~1LL;
  const int shift = (int)(t.g0 - ga);
  const int pairs = (shift + (t.nf - 1) * q + k_in + 1) >> 1;
  const int left = (int)((long long)t.c * l + l - ga);   // samples to the end
  const float2* src = x + ga;
  const unsigned dst = (unsigned)__cvta_generic_to_shared(buf);
  for (int i = threadIdx.x; i < pairs; i += blockDim.x) {
    const int rem = left - 2 * i;
    const int bytes = rem >= 2 ? 16 : (rem == 1 ? 8 : 0);
    cp_async16(dst + 16 * i, bytes ? (const void*)(src + 2 * i)
                                   : (const void*)x, bytes);
  }
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
resample_kernel(const float2* __restrict__ x, const float* __restrict__ bank,
                float2* __restrict__ y, int l, int p, int q, int n_frames,
                int slots, int frames, int tiles, int n_tiles, int buf_len) {
  extern __shared__ __align__(16) float2 sx[];
  const int nt = blockDim.x;
  const int k_in = (int)(((long long)(p - 1) * q) / p) + kTaps;

  // this thread's items: taps in registers, input offset of the newest
  // tap from the pass's first sample, output index from the pass's first
  float tap[R][kTaps];
  int in_off[R], out_off[R], slot[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int k = ((int)blockIdx.y * R + m) * nt + (int)threadIdx.x;
    int s = frames, r = 0;          // a dead item's slot fails every pass
    if (k < slots * p) {
      s = k / p;
      r = k - s * p;
    }
    const long long rq = (long long)r * q;
    const float* b = bank + (rq % p) * kTaps;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) tap[m][t] = __ldg(b + t);
    in_off[m] = s * q + (int)(rq / p) + kTaps - 1;
    out_off[m] = k;
    slot[m] = s;
  }

  int u = blockIdx.x;
  if (u >= n_tiles) return;
  Tile cur = tile_at(u, tiles, frames, n_frames, l, q);
  stage(x, sx, cur, l, q, k_in);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = 0; u < n_tiles; ++i, u += gridDim.x) {
    Tile nxt = cur;
    if (u + (int)gridDim.x < n_tiles) {
      nxt = tile_at(u + gridDim.x, tiles, frames, n_frames, l, q);
      stage(x, sx + ((i + 1) & 1) * buf_len, nxt, l, q, k_in);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();

    const float2* xs = sx + (i & 1) * buf_len + (int)(cur.g0 & 1);
    float2* yt = y + ((long long)cur.c * n_frames + cur.j0) * p;
    for (int f0 = 0; f0 < cur.nf; f0 += slots) {
      const float2* xf = xs + f0 * q;
      float2* yf = yt + f0 * p;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        if (f0 + slot[m] < cur.nf) {
          const float2* xp = xf + in_off[m];
          float2 v = xp[0];
          float ar = tap[m][0] * v.x;
          float ai = tap[m][0] * v.y;
#pragma unroll
          for (int t = 1; t < kTaps; ++t) {
            v = xp[-t];
            ar = ar + tap[m][t] * v.x;
            ai = ai + tap[m][t] * v.y;
          }
          yf[out_off[m]] = make_float2(ar, ai);
        }
      }
    }
    __syncthreads();      // the buffer is staged again two tiles on
    cur = nxt;
  }
}

template <int R>
int launch(const float* x, const float* bank, float* y, int c, int l, int p,
           int q, int n_frames, int threads, int slots, int groups,
           int frames, int tiles, int blocks, int buf_len,
           cudaStream_t stream) {
  const size_t smem = 2 * (size_t)buf_len * sizeof(float2);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        resample_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)blocks, (unsigned)groups);
  resample_kernel<R><<<grid, threads, smem, stream>>>(
      reinterpret_cast<const float2*>(x), bank, reinterpret_cast<float2*>(y),
      l, p, q, n_frames, slots, frames, tiles, c * tiles, buf_len);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (C, L) complex as interleaved f32 pairs, 16-byte aligned; bank: (P, 12)
// f32; y: (C, n_frames*P) interleaved.  The launch plan (threads, items a
// thread, frame slots a pass, phase groups, frames a tile, tiles a channel,
// blocks, samples a staging buffer) comes from the wrapper's launch_plan.
// Returns cudaGetLastError().
extern "C" int lteax_resample(const float* x, const float* bank, float* y,
                              int c, int l, int p, int q, int n_frames,
                              int threads, int per_thread, int slots,
                              int groups, int frames, int tiles, int blocks,
                              int buf_len, cudaStream_t stream) {
  if (c <= 0 || n_frames <= 0) return 0;
  if (threads <= 0 || threads > kMaxThreads ||
      (reinterpret_cast<unsigned long long>(x) & 15))
    return (int)cudaErrorInvalidValue;
  switch (per_thread) {
    case 1:
      return launch<1>(x, bank, y, c, l, p, q, n_frames, threads, slots,
                       groups, frames, tiles, blocks, buf_len, stream);
    case 2:
      return launch<2>(x, bank, y, c, l, p, q, n_frames, threads, slots,
                       groups, frames, tiles, blocks, buf_len, stream);
    case 4:
      return launch<4>(x, bank, y, c, l, p, q, n_frames, threads, slots,
                       groups, frames, tiles, blocks, buf_len, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
