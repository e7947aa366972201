// Fused masked comb-ISTFT over an NHWC mask (K3), for Hopper (sm_90a), FP32 FFMA.
//
// Replaces the TPU kernel spatialaudiogen_tpu/ops/pallas_kernels.py:_nhwc_kernel
// (launched by _nhwc_forward, public API masked_istft_nhwc_pallas). Mono
// input; per (b, track c), with m = mask[b, :, :, c]:
//
//   X[t, n]    = ((re*m)[t] @ C + (im*m)[t] @ S)[n] / F          n in [0, F)
//   out[c, p]  = 1/4 * sum of X[t, n] over (t, n) with (t - 3)*hop + n == p
//
// which is K1 (masked_istft.cu) with the mask read in the U-Net deconv's
// native layout, (B, T, F, C) with the tracks C innermost, instead of
// track-major. The wrapper passes the mask as a strided view (the cropped
// channels_last deconv output) and the kernel reads it in place: no
// transpose copy reaches device memory.
//
// Design: K1's block decomposition. A block owns one batch row, a group of
// up to 4 tracks and 32 hop residues r, computes X for every frame of its
// tracks at the 4*32 columns {q*hop + r} into shared memory, and does the
// comb overlap-add from there, writing each output sample once: no atomics,
// deterministic. The A operand of a stage is (4 tracks x 32 frames) rows by
// 8 frequencies of re*m followed by the same 8 of im*m, so one mask value
// feeds both halves of the contraction. A thread stages one (frame, freq):
// one 16-byte load (8 bytes for a bf16 mask) brings the 4 tracks' values,
// which it multiplies by re and im and writes transposed into the k-major
// A tile (conflict-free: a warp covers 4 frames x 8 freqs). Where the
// tracks are not 4 aligned contiguous values (another stride, C not a
// multiple of 4) the same thread loads them one by one.
//
// What bounds it: the contraction is 2*F deep over (tracks x frames) rows,
// about 3.8 GFLOP per flagship window (32 tracks x 28 frames, F = 1024)
// against about 4.7 MB of input and output, so arithmetic bounds it, as K1.
// FP32 FFMA with an 8x8 register tile per thread and a register prefetch
// of the next stage; tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOverlap = 4;
constexpr int RT = 32;                  // hop residues per block
constexpr int BN = kOverlap * RT;       // X columns per block: 4 quarters x 32 residues
constexpr int kTracks = 4;              // tracks per block, at most
constexpr int FT = 32;                  // frames per row chunk
constexpr int BM = kTracks * FT;        // A rows per chunk: row = track*FT + frame
constexpr int FK = 8;                   // frequencies per stage
constexpr int BK = 2 * FK;              // contraction depth per stage: re half, im half
constexpr int kThreads = 256;           // 16 x 16 threads, 8x8 accumulators each
constexpr int A_LD = BM + 4;            // A_s: k-major [BK][A_LD]
constexpr int B_LD = BN;                // B_s: k-major [BK][B_LD]
constexpr int X_LD = BN;                // X_s: row-major [track*T + frame][X_LD]

static_assert(kThreads == FT * FK, "one (frame, freq) of the A tile per thread");

struct Params {
  const float* re;
  const float* im;
  const void* mask;
  const float* cos_b;
  const float* sin_b;
  float* out;
  int n_tracks;
  int n_frames;          // frames used (a multiple of 4)
  int n_freqs;           // F, a multiple of 4 * RT
  int tracks_per_block;  // 1..kTracks
  int out_len;
  int vec;               // the 4 tracks of a (frame, freq) are one aligned vector
  long long re_s_b, re_s_t;            // element strides; re/im's F axis is contiguous
  long long im_s_b, im_s_t;
  long long m_s_b, m_s_t, m_s_f, m_s_c;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float4 load_tracks4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load_tracks4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Two blocks per SM, as K1: 128 registers a thread.
template <typename MaskT>
__global__ void __launch_bounds__(kThreads, 2)
masked_istft_nhwc_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);   // [BK][A_LD]
  float* B_s = A_s + BK * A_LD;                   // [BK][B_LD]
  float* X_s = B_s + BK * B_LD;                   // [n_tr * T][X_LD]

  const int F = p.n_freqs;
  const int T = p.n_frames;
  const int hop = F / kOverlap;
  const int n_res = hop / RT;
  const int n_groups = (p.n_tracks + p.tracks_per_block - 1) / p.tracks_per_block;
  int blk = blockIdx.x;
  const int r0 = (blk % n_res) * RT;
  blk /= n_res;
  const int tr0 = (blk % n_groups) * p.tracks_per_block;
  const long long b = blk / n_groups;
  const int n_tr = min(p.tracks_per_block, p.n_tracks - tr0);

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const MaskT* mask = static_cast<const MaskT*>(p.mask) + b * p.m_s_b +
                      (long long)tr0 * p.m_s_c;
  const float* re = p.re + b * p.re_s_b;
  const float* im = p.im + b * p.im_s_b;
  const int n_k_tiles = F / FK;

  // A staging: this thread's (frame, freq) of the tile. A warp reads 4
  // frames x 8 consecutive freqs and writes 32 distinct banks.
  const int a_f = tid % FK;
  const int a_t = tid / FK;
  // B staging (BK x BN): rows k < FK are C rows, k >= FK the same S rows;
  // a thread loads 4 consecutive columns, a warp 4 x 128 bytes of one row.
  int b_k[2], b_col[2], b_n[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + kThreads * i;
    b_k[i] = idx >> 5;
    b_col[i] = (idx & 31) * 4;
    // column c = q*RT + rr of the tile is frequency n = q*hop + r0 + rr
    b_n[i] = (b_col[i] / RT) * hop + r0 + (b_col[i] % RT);
  }

  for (int t0 = 0; t0 < T; t0 += FT) {
    const int t = t0 + a_t;
    const bool a_ok = t < T;
    const MaskT* m_ptr = mask + (long long)(a_ok ? t : 0) * p.m_s_t + a_f * p.m_s_f;
    const float* re_ptr = re + (long long)(a_ok ? t : 0) * p.re_s_t + a_f;
    const float* im_ptr = im + (long long)(a_ok ? t : 0) * p.im_s_t + a_f;

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    // next stage, prefetched into registers
    float4 pm;
    float pr, pi;
    float4 pb[2];

    auto fetch = [&](int kt) {
      const int f0 = kt * FK;
      pm = make_float4(0.f, 0.f, 0.f, 0.f);
      pr = pi = 0.f;
      if (a_ok) {
        const MaskT* mp = m_ptr + (long long)f0 * p.m_s_f;
        if (p.vec) {
          pm = load_tracks4(mp);
        } else {
          pm.x = to_float(mp[0]);
          if (n_tr > 1) pm.y = to_float(mp[p.m_s_c]);
          if (n_tr > 2) pm.z = to_float(mp[2 * p.m_s_c]);
          if (n_tr > 3) pm.w = to_float(mp[3 * p.m_s_c]);
        }
        pr = re_ptr[f0];
        pi = im_ptr[f0];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* basis = b_k[i] < FK ? p.cos_b : p.sin_b;
        pb[i] = *reinterpret_cast<const float4*>(
            basis + (long long)(f0 + b_k[i] % FK) * F + b_n[i]);
      }
    };

    fetch(0);
    for (int kt = 0; kt < n_k_tiles; ++kt) {
      float* a = A_s + a_f * A_LD + a_t;          // re*m rows, then im*m rows
      a[0] = pr * pm.x;
      a[FT] = pr * pm.y;
      a[2 * FT] = pr * pm.z;
      a[3 * FT] = pr * pm.w;
      a += FK * A_LD;
      a[0] = pi * pm.x;
      a[FT] = pi * pm.y;
      a[2 * FT] = pi * pm.z;
      a[3 * FT] = pi * pm.w;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float4*>(B_s + b_k[i] * B_LD + b_col[i]) = pb[i];
      __syncthreads();
      if (kt + 1 < n_k_tiles) fetch(kt + 1);   // in flight during the FMAs
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(A_s + kk * A_LD + ty * 8);
        const float4 a1 = *reinterpret_cast<const float4*>(A_s + kk * A_LD + ty * 8 + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(B_s + kk * B_LD + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(B_s + kk * B_LD + 64 + tx * 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // local row ty*8 + i is (track (ty*8 + i) / FT, frame t0 + (ty*8 + i) % FT);
    // the 8 rows of a thread lie in one track
    const int tl = (ty * 8) / FT;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int tt = t0 + (ty * 8) % FT + i;
      if (tl < n_tr && tt < T) {
        float* x = X_s + (tl * T + tt) * X_LD;
        *reinterpret_cast<float4*>(x + tx * 4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(x + 64 + tx * 4) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    }
  }
  __syncthreads();

  // Comb overlap-add: out[j*hop + r] = 1/(4F) * sum_q X[j+3-q][q*RT + rr].
  // A warp handles 32 consecutive residues: conflict-free shared reads and
  // one 128-byte store.
  const float scale = 1.f / (float(kOverlap) * float(F));
  const int n_j = T - (kOverlap - 1);
  const int total = n_tr * n_j * RT;
  for (int idx = tid; idx < total; idx += kThreads) {
    const int rr = idx % RT;
    const int rest = idx / RT;
    const int j = rest % n_j;
    const int tl = rest / n_j;
    const float* x = X_s + (tl * T + j + kOverlap - 1) * X_LD + rr;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kOverlap; ++q) s += x[q * (RT - X_LD)];
    p.out[(b * p.n_tracks + tr0 + tl) * p.out_len + j * hop + r0 + rr] = s * scale;
  }
}

}  // namespace

extern "C" {

// Shared memory one launch needs, in bytes.
long long sag_masked_istft_nhwc_smem_bytes(int tracks_per_block, int n_frames) {
  return (long long)(BK * A_LD + BK * B_LD + (long long)tracks_per_block * n_frames * X_LD) *
         (long long)sizeof(float);
}

// Launches K3 on `stream` (a cudaStream_t) of device `device`. re, im are
// (n_b, >= n_frames, n_freqs) float32 with a contiguous last axis; mask is
// (n_b, >= n_frames, n_freqs, n_tracks) float32 or bfloat16 with any
// element strides; `vec` says its tracks are 4-aligned contiguous vectors
// (tracks_per_block 4, m_s_c 1, the other strides multiples of 4). out is
// (n_b, n_tracks, (n_frames - 3) * n_freqs / 4) float32, contiguous.
// Returns the cudaError_t of the launch (0 on success).
int sag_masked_istft_nhwc_fwd(const float* re, const float* im, const void* mask,
                              int mask_is_bf16, int vec, const float* cos_b,
                              const float* sin_b, float* out, int n_b, int n_tracks,
                              int n_frames, int n_freqs, int tracks_per_block,
                              long long re_s_b, long long re_s_t, long long im_s_b,
                              long long im_s_t, long long m_s_b, long long m_s_t,
                              long long m_s_f, long long m_s_c, int device, void* stream) {
  if (n_b < 1 || n_tracks < 1 || tracks_per_block < 1 || tracks_per_block > kTracks ||
      n_frames < kOverlap || n_frames % kOverlap != 0 || n_freqs % (kOverlap * RT) != 0 ||
      (vec && (tracks_per_block != kTracks || n_tracks % kTracks != 0 || m_s_c != 1))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  Params p;
  p.re = re;
  p.im = im;
  p.mask = mask;
  p.cos_b = cos_b;
  p.sin_b = sin_b;
  p.out = out;
  p.n_tracks = n_tracks;
  p.n_frames = n_frames;
  p.n_freqs = n_freqs;
  p.tracks_per_block = tracks_per_block;
  p.out_len = (n_frames - (kOverlap - 1)) * (n_freqs / kOverlap);
  p.vec = vec;
  p.re_s_b = re_s_b;
  p.re_s_t = re_s_t;
  p.im_s_b = im_s_b;
  p.im_s_t = im_s_t;
  p.m_s_b = m_s_b;
  p.m_s_t = m_s_t;
  p.m_s_f = m_s_f;
  p.m_s_c = m_s_c;

  const long long n_groups = (n_tracks + tracks_per_block - 1) / tracks_per_block;
  const long long n_blocks = (long long)n_b * n_groups * (n_freqs / kOverlap / RT);
  const long long smem = sag_masked_istft_nhwc_smem_bytes(tracks_per_block, n_frames);
  void (*kernel)(const Params) = mask_is_bf16 ? masked_istft_nhwc_kernel<__nv_bfloat16>
                                              : masked_istft_nhwc_kernel<float>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned int)n_blocks, kThreads, (size_t)smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
