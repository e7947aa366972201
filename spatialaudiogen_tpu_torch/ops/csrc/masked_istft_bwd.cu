// Backward of the fused masked comb-ISTFT (K2) for Hopper (sm_90a), on the
// tensor cores through wgmma (istft_mma.cuh): bf16 for
// pallas_precision="default", 3xTF32 for "highest".
//
// Replaces the TPU kernel spatialaudiogen_tpu/ops/pallas_kernels.py:_bwd_kernel
// (launched by _backward_pallas, the custom VJP of masked_istft_pallas; it
// is also the backward of K3, as _nhwc_bwd). The forward (masked_istft.cu)
// maps frame t, column n of a track to output sample p = (t - 3)*hop + n.
// Its backward, for one (b, in) row, per track r:
//
//   gx[r, t, n]   = g[r, (t - 3)*hop + n] / (4F)      (0 outside [0, out_len))
//   g_rm[r, t, f] = sum_n gx[r, t, n] C[n, f]          (C, S symmetric: no transpose)
//   g_im[r, t, f] = sum_n gx[r, t, n] S[n, f]
//   d_mask[r, t, f] = g_rm * re[t, f] + g_im * im[t, f]        (mask dtype)
//   d_re[t, f]      = sum_r g_rm * m[r, t, f]
//   d_im[t, f]      = sum_r g_im * m[r, t, f]
//
// Design. A block owns one (b, in) row and a tile of FT = 128 output
// frequencies f (F < 128, or the last tile of an F that is not a multiple
// of 128: fewer, and the basis image's other columns are zero), and walks
// ALL tracks in passes of 128 (track, frame) rows
// (4 tracks at T = 28; tracks longer than 128 frames in chunks of 128), so
// the track sums of d_re/d_im never leave the block: no atomics,
// deterministic. The two GEMMs share their A operand (gx), so a pass is one
// GEMM against B = [C[:, f-tile] | S[:, f-tile]] (256 columns), depth F.
// A is gathered from g in registers (istft_mma.cuh): the comb scatter and
// the 1/(4F) scale happen as it is staged, before the rounding to bf16 or
// the tf32 split, so gx never reaches device memory. B steps are laid out
// once per (F, device, form) by ops/dft.py:mma_basis and copied whole by
// the bulk TMA engine. The epilogue of a pass writes d_mask straight from
// the accumulators (each thread holds g_rm and g_im of the same (row, f)),
// parks g_rm*m and g_im*m in shared memory, and then thread c sums column
// c over the pass's tracks in a fixed order and adds it to d_re/d_im in
// device memory, which only this thread of this block touches: the same
// order on every run. Frames beyond the last multiple of 4 are zeroed by
// the wrapper.
//
// What bounds it on an H100 (batch 16 at the flagship): the same 60.1
// GFLOP as K1, so 0.061 ms for "default" (bf16 at 989 TFLOP/s) and 0.364 ms
// for "highest" (3xTF32); bytes: g 13.1 MB, re/im 3.7 MB, the mask read
// and d_mask written (58.7 MB each in f32), d_re/d_im 3.7 MB: 0.041 ms. What
// one call moves beyond that: each of the F/FT = 8 frequency tiles of a row
// reads the row's g (8 x 13.1 MB, from L2 after the first) and re-reads its
// basis tile once per pass (512 KB bf16, 2 MB 3xTF32; 8 passes at T = 28),
// 512 MB (2 GB) from L2 at batch 16, and each pass reads and writes its
// block's d_re/d_im columns (3.7 MB a pass in all).

#include "istft_mma.cuh"

namespace {

using namespace istft_mma;

constexpr int FT = kN / 2;               // output frequencies per block

struct Params {
  const float* g;          // (n_bn, n_tracks, out_len), contiguous
  const float* re;
  const float* im;
  const void* mask;
  const uint8_t* b_hi;     // laid-out bases (bf16, or the tf32 hi part)
  const uint8_t* b_lo;     // the tf32 lo part (3xTF32 only)
  void* d_mask;            // (n_bn, n_tracks, n_frames_total, F), contiguous
  float* d_re;             // (n_bn, n_frames_total, F), contiguous
  float* d_im;
  int n_tracks;
  int n_frames;            // frames used (a multiple of 4)
  int n_frames_total;      // frames of the outputs (>= n_frames)
  int n_freqs;             // F, a multiple of 32
  int out_len;
  long long re_s_bn, re_s_t;           // element strides; the F axis is contiguous
  long long im_s_bn, im_s_t;
  long long m_s_bn, m_s_tr, m_s_t;
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The A values of the thread's two rows: v[0..3] and v[4..7] = gx at
// samples 32 s + 4 tig + (0..3) and 32 s + 16 + 4 tig + (0..3) of the frame.
struct Loader {
  const float* g[2];     // the row's track of g
  int p0[2];             // output sample of the frame's sample 4 tig (may be < 0)
  bool ok[2];
  int out_len;
  float scale;
  float4 gv[2][2];

  __device__ __forceinline__ void fetch(int s) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // out_len and the sample offsets are multiples of 4, so a float4 of
        // g lies wholly inside or wholly outside [0, out_len)
        const int i = p0[r] + 32 * s + 16 * h;
        gv[r][h] = ok[r] && i >= 0 && i < out_len ? load4(g[r] + i)
                                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      }
  }

  __device__ __forceinline__ void values(float (&v)[2][8]) const {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        v[r][4 * h + 0] = gv[r][h].x * scale;
        v[r][4 * h + 1] = gv[r][h].y * scale;
        v[r][4 * h + 2] = gv[r][h].z * scale;
        v[r][4 * h + 3] = gv[r][h].w * scale;
      }
  }
};

// kPartial: F is not a multiple of FT, so a tile may hold fewer frequencies
// (a template branch: with F a multiple of FT the guards compile away, as
// they cost the flagship's batch-128 launch 11% when they were always there).
template <int P, typename MaskT, bool kPartial>
__global__ void __launch_bounds__(kThreads, 1) masked_istft_bwd_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* P_s = reinterpret_cast<float*>(smem);   // [kPassRows][kOutLD], after each GEMM

  const int F = p.n_freqs;
  const int T = p.n_frames;
  const int hop = F / kOverlap;
  const int n_ftiles = kPartial ? (F + FT - 1) / FT : F / FT;
  const int f_tile = blockIdx.x % n_ftiles;
  const int f0 = f_tile * FT;
  const int n_f = kPartial ? min(FT, F - f0) : FT;   // the tile's frequencies, a multiple of 32
  const long long bn = blockIdx.x / n_ftiles;
  const Rows rows(T);
  const int chunk = rows.per_tile ? T : kPassRows;   // frames of a pass
  const int tig = threadIdx.x % 4;

  Ring<P> ring;
  ring.init(smem);

  const MaskT* mask = static_cast<const MaskT*>(p.mask);
  MaskT* d_mask = static_cast<MaskT*>(p.d_mask);
  const int n_steps = F / kStepK;
  const size_t tile_bytes = (size_t)n_steps * form_bytes<P>();
  const uint8_t* b_hi = p.b_hi + f_tile * tile_bytes;
  const uint8_t* b_lo = p.b_lo + f_tile * tile_bytes;

  Loader ld;
  ld.out_len = p.out_len;
  ld.scale = 1.f / (float(kOverlap) * float(F));

  for (int tr0 = 0; tr0 < p.n_tracks; tr0 += rows.per_pass) {
    const int n_tr = min(rows.per_pass, p.n_tracks - tr0);
    for (int t0 = 0; t0 < T; t0 += chunk) {
      const int nt = min(chunk, T - t0);
      int trk[2], frm[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int tl, tt;
        ld.ok[r] = rows.at(frag_row(r), tl, tt) && tl < n_tr && tt < nt;
        trk[r] = ld.ok[r] ? tr0 + tl : 0;
        frm[r] = ld.ok[r] ? t0 + tt : 0;
        ld.g[r] = p.g + (bn * p.n_tracks + trk[r]) * (long long)p.out_len;
        ld.p0[r] = (frm[r] - (kOverlap - 1)) * hop + 4 * tig;
      }

      float acc[128];
      ring.gemm(acc, b_hi, b_lo, n_steps, ld);

      // Epilogue: accumulator j (< 16) holds g_rm and j + 16 g_im of the
      // same frequencies f0 + 8 j + 2 tig + (0, 1).
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!ld.ok[r]) continue;
        const int t = frm[r];
        const float* re = p.re + bn * p.re_s_bn + (long long)t * p.re_s_t + f0 + 2 * tig;
        const float* im = p.im + bn * p.im_s_bn + (long long)t * p.im_s_t + f0 + 2 * tig;
        const MaskT* m = mask + bn * p.m_s_bn + (long long)trk[r] * p.m_s_tr +
                         (long long)t * p.m_s_t + f0 + 2 * tig;
        MaskT* dm = d_mask + ((bn * p.n_tracks + trk[r]) * p.n_frames_total + t) * (long long)F +
                    f0 + 2 * tig;
        float* prod = P_s + frag_row(r) * kOutLD + 2 * tig;
        // loads in batches of 4 frequency pairs, ahead of the stores (which
        // the compiler may not move loads across)
#pragma unroll
        for (int j0 = 0; j0 < FT / 8; j0 += 4) {
          if (kPartial && 8 * j0 >= n_f) break;   // columns past the tile's frequencies
          float2 rv[4], iv[4], mv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            rv[u] = load2(re + 8 * (j0 + u));
            iv[u] = load2(im + 8 * (j0 + u));
            mv[u] = load2(m + 8 * (j0 + u));
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = j0 + u;
            const float2 rm = make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
            const float2 ii =
                make_float2(acc[4 * (j + 16) + 2 * r], acc[4 * (j + 16) + 2 * r + 1]);
            store2(dm + 8 * j, make_float2(rm.x * rv[u].x + ii.x * iv[u].x,
                                           rm.y * rv[u].y + ii.y * iv[u].y));
            store2(prod + 8 * j, make_float2(rm.x * mv[u].x, rm.y * mv[u].y));
            store2(prod + FT + 8 * j, make_float2(ii.x * mv[u].x, ii.y * mv[u].y));
          }
        }
      }
      __syncthreads();

      // Track sum in a fixed order: column c is always summed by thread c,
      // which alone reads and writes it in d_re / d_im (columns past the
      // tile's frequencies are skipped).
      if (!kPartial || threadIdx.x % FT < n_f) {
        const int c = threadIdx.x;
        float* dst = (c < FT ? p.d_re : p.d_im) + bn * p.n_frames_total * (long long)F + f0 +
                     (c % FT);
        // the earlier passes' sums of 8 frames loaded together, then added to
        for (int tt0 = 0; tt0 < nt; tt0 += 8) {
          float sum[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            sum[u] = tr0 > 0 && tt0 + u < nt ? dst[(long long)(t0 + tt0 + u) * F] : 0.f;
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (tt0 + u >= nt) break;
            for (int tl = 0; tl < n_tr; ++tl) sum[u] += P_s[rows.row(tl, tt0 + u) * kOutLD + c];
            dst[(long long)(t0 + tt0 + u) * F] = sum[u];
          }
        }
      }
      __syncthreads();   // the next pass's stages overwrite P_s
    }
  }
}

template <int P, bool kPartial>
void* pick_mask(int mask_is_bf16) {
  return mask_is_bf16 ? (void*)masked_istft_bwd_kernel<P, __nv_bfloat16, kPartial>
                      : (void*)masked_istft_bwd_kernel<P, float, kPartial>;
}

template <int P>
void* pick(int mask_is_bf16, bool partial) {
  return partial ? pick_mask<P, true>(mask_is_bf16) : pick_mask<P, false>(mask_is_bf16);
}

}  // namespace

extern "C" {

// Shared memory one launch needs, in bytes (the same for both precisions).
long long sag_masked_istft_bwd_smem_bytes() { return kSmemBytes; }

// Launches the kernel on `stream` (a cudaStream_t) of device `device`.
// precision: 0 bf16 ("default"), 1 3xTF32 ("highest"); b_hi/b_lo the laid-out
// bases of that precision (ops/dft.py:mma_basis, kernel "bwd").
// g is (n_bn, n_tracks, (n_frames - 3) * n_freqs / 4) float32, contiguous;
// d_mask (mask dtype), d_re and d_im are contiguous with n_frames_total
// frames, of which the kernel writes the first n_frames.
// Returns the cudaError_t of the launch (0 on success).
int sag_masked_istft_bwd(const float* g, const float* re, const float* im,
                         const void* mask, int mask_is_bf16, int precision,
                         const void* b_hi, const void* b_lo, void* d_mask, float* d_re,
                         float* d_im, int n_bn, int n_tracks, int n_frames,
                         int n_frames_total, int n_freqs, long long re_s_bn,
                         long long re_s_t, long long im_s_bn, long long im_s_t,
                         long long m_s_bn, long long m_s_tr, long long m_s_t, int device,
                         void* stream) {
  if (n_bn < 1 || n_tracks < 1 || n_frames < kOverlap || n_frames % kOverlap != 0 ||
      n_frames_total < n_frames || n_freqs < 32 || n_freqs % 32 != 0 ||
      (precision != kBF16 && precision != kTF32x3)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  Params p;
  p.g = g;
  p.re = re;
  p.im = im;
  p.mask = mask;
  p.b_hi = static_cast<const uint8_t*>(b_hi);
  p.b_lo = static_cast<const uint8_t*>(b_lo);
  p.d_mask = d_mask;
  p.d_re = d_re;
  p.d_im = d_im;
  p.n_tracks = n_tracks;
  p.n_frames = n_frames;
  p.n_frames_total = n_frames_total;
  p.n_freqs = n_freqs;
  p.out_len = (n_frames - (kOverlap - 1)) * (n_freqs / kOverlap);
  p.re_s_bn = re_s_bn;
  p.re_s_t = re_s_t;
  p.im_s_bn = im_s_bn;
  p.im_s_t = im_s_t;
  p.m_s_bn = m_s_bn;
  p.m_s_tr = m_s_tr;
  p.m_s_t = m_s_t;

  const long long n_blocks = (long long)n_bn * ((n_freqs + FT - 1) / FT);
  const bool partial = n_freqs % FT != 0;
  void* kernel = precision == kBF16 ? pick<kBF16>(mask_is_bf16, partial)
                                    : pick<kTF32x3>(mask_is_bf16, partial);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchKernel(kernel, dim3((unsigned int)n_blocks), dim3(kThreads), args,
                         (size_t)kSmemBytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
