// Fused masked comb-ISTFT over an NHWC mask (K3) for Hopper (sm_90a), on the
// tensor cores through wgmma (istft_mma.cuh): bf16 for
// pallas_precision="default", 3xTF32 for "highest".
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
// Design: K1 with another source for the mask. The block (FwdBlock: one
// batch row, the tracks of one 128-row pass, a chunk of frames, 64 hop
// residues or hop of them when F < 256), the rows
// (Rows: whole tracks per 64-row warpgroup tile), the GEMM (Ring: wgmma
// m64n256 on a bulk-TMA ring of basis stages), the basis images
// (ops/dft.py:mma_basis, kernel "fwd", the same tensors K1 reads), the k
// order of a step (16 frequencies of re*m against C, the same 16 of im*m
// against S) and the epilogue (fwd_epilogue: X tile in shared memory, comb
// overlap-add writing each sample once, no atomics) are K1's, so K3 gives
// K1's result on the mask made track-major.
//
// The mask. K1 loads one float4 of the mask along F per fragment row; here
// the F stride is C elements (128 bytes at 32 f32 tracks), so that would be
// four scalar loads, each in its own 32-byte sector. Instead the block
// stages its mask of a step (its tracks x T frames x 16 frequencies, at
// most 128 rows x 16 = 8 KB as f32) through shared memory:
//   - vector route: one load brings the 4 tracks of one (t, f), 16 bytes
//     (f32) or 8 (bf16). A thread loads at most 2 such pieces of step
//     s + 2 before the MMAs of step s and writes them, converted to f32,
//     transposed into the track-major staging tile right after the block
//     barrier that ends step s (Ring::gemm's stage() hook), so the loads
//     overlap the MMAs, a thread still waiting on them never holds up that
//     barrier, and the staging needs no barrier of its own: the barrier
//     that ends step s + 1 publishes it. Three staging buffers rotate.
//     (Staged before that barrier, one step ahead, the kernel was slower
//     than K1 on a track-major copy: the slowest thread's loads held up
//     the whole block at every step.)
//     Taken when the block's tracks come in aligned groups of 4 (C and the
//     tracks per pass multiples of 4, the tracks contiguous, the other
//     strides multiples of 4, the base aligned): the model's mask at the
//     flagship (32 tracks, T = 28).
//   - scalar route: otherwise (C not a multiple of 4, another stride, an
//     unaligned base), each value of the step is loaded alone in stage(),
//     after the barrier, at most 8 per thread. The same kernel, templated.
// Each thread then reads its two rows' four mask values as one float4 from
// the staging tile (row (track, frame) at (track * T + frame) * 16,
// conflict-free for both the transposing stores and the float4 reads),
// multiplies them by re and im loaded from global memory as float4 along
// F, as K1 does, and packs bf16 or the tf32 hi/lo split in registers.
// A TMA tiled copy of the mask tile (a CUtensorMap over the 4-D view) would
// spare the loads' registers, but its box needs at least 16 bytes along the
// tracks (4 bf16 tracks are 8), cuTensorMapEncodeTiled would have to encode
// the map per launch, and the staging here already rides on the ring's
// per-step barriers.
//
// What bounds it on an H100 (batch 16 at the flagship: 16 x 32 tracks x 28
// frames, F = 1024): K1's work, 60.1 GFLOP against 58.7 MB of f32 mask
// (29.4 MB bf16), 3.7 MB of spectra and a 13.1 MB output; "default" (bf16,
// 989 TFLOP/s) 0.061 ms of operations against 0.023 ms of bytes,
// "highest" (3xTF32, three passes at 495 TFLOP/s) 0.364 ms. Beyond K1's
// traffic: each block reads 16 bytes (f32; 8 bf16) of every 128-byte row
// of tracks it stages, so the L2 moves a 32-byte sector for each, about
// twice (f32) or four times (bf16) the mask bytes a track-major read would.

#include "istft_mma.cuh"

namespace {

using namespace istft_mma;

constexpr int kStepFreqs = 16;                          // frequencies per GEMM step
constexpr int kStageFloats = kPassRows * kStepFreqs;    // one staging buffer
constexpr int kStageBufs = 3;                           // steps s, s + 1, s + 2
constexpr int kStageBytes = kStageBufs * kStageFloats * 4;
constexpr int kVecTracks = 4;                           // tracks per vector load
constexpr int kVecLoads = kStageFloats / kVecTracks / kThreads;   // per thread, at most
constexpr int kScalarLoads = kStageFloats / kThreads;             // per thread, at most
constexpr int kNhwcSmemBytes = kSmemBytes + kStageBytes;

struct Params {
  const float* re;
  const float* im;
  const void* mask;
  const uint8_t* b_hi;   // laid-out bases (bf16, or the tf32 hi part)
  const uint8_t* b_lo;   // the tf32 lo part (3xTF32 only)
  float* out;
  int n_tracks;
  int n_frames;          // frames used (a multiple of 4)
  int n_freqs;           // F, a multiple of 32
  int out_len;
  long long re_s_b, re_s_t;            // element strides; re/im's F axis is contiguous
  long long im_s_b, im_s_t;
  long long m_s_b, m_s_t, m_s_f, m_s_c;
};

// The 4 tracks of one (t, f) as loaded (converted to f32 where they are
// staged, so the load stays in flight across the MMAs).
template <typename MaskT> struct Tracks4;
template <> struct Tracks4<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) { v = load4(p); }
  __device__ __forceinline__ float4 get() const { return v; }
};
template <> struct Tracks4<__nv_bfloat16> {
  uint2 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ float4 get() const {
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// The A values of the thread's two rows: v[0..3] = re*m and v[4..7] = im*m
// at frequencies 16 s + 4 tig + (0..3), the mask read from the staging
// tile that stage(s) filled.
template <typename MaskT, bool kVec> struct Loader {
  // the thread's rows
  const float* re[2];
  const float* im[2];
  bool ok[2];
  int col;                 // 4 tig
  int rd[2];               // the row's float offset in a staging buffer
  float4 rv[2], iv[2];
  // the staging
  float* stage_s;          // kStageBufs buffers of kStageFloats
  int n_stage;             // values (scalar) or 4-track pieces (vector) a step stages
  int n_steps;
  int read = 0;            // step of the next values()
  long long step_elems;    // mask elements between steps: 16 F strides
  // vector route: the thread's pieces
  const MaskT* mp[kVecLoads];
  int wr[kVecLoads];       // staging offset of the piece's first track
  Tracks4<MaskT> pv[kVecLoads];
  // scalar route: the block's corner of the mask and its strides
  const MaskT* m0;
  long long m_s_t, m_s_f, m_s_c;
  int T;                   // frames of the block's chunk

  // vector route: start the loads of step s's pieces
  __device__ __forceinline__ void load_pieces(int s) {
#pragma unroll
    for (int k = 0; k < kVecLoads; ++k)
      if ((int)threadIdx.x + k * kThreads < n_stage) pv[k].load(mp[k] + s * step_elems);
  }

  // re and im of step s and (vector route) the mask pieces of step s + 1,
  // which stage(s + 1) writes after the next barrier.
  __device__ __forceinline__ void fetch(int s) {
    const int f = kStepFreqs * s + col;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (ok[r]) {
        rv[r] = load4(re[r] + f);
        iv[r] = load4(im[r] + f);
      } else {
        rv[r] = iv[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    if constexpr (kVec) {
      if (s + 1 < n_steps) load_pieces(s + 1);
    }
  }

  // Step s's mask into its staging buffer: the pieces fetch(s - 1) loaded
  // (step 0 loads its own), or (scalar route) loaded here.
  __device__ __forceinline__ void stage(int s) {
    float* buf = stage_s + (s % kStageBufs) * kStageFloats;
    if constexpr (kVec) {
      if (s == 0) load_pieces(0);
      const int ts = T * kStepFreqs;   // next track of the same (t, f)
#pragma unroll
      for (int k = 0; k < kVecLoads; ++k) {
        if ((int)threadIdx.x + k * kThreads < n_stage) {
          const float4 x = pv[k].get();
          buf[wr[k]] = x.x;
          buf[wr[k] + ts] = x.y;
          buf[wr[k] + 2 * ts] = x.z;
          buf[wr[k] + 3 * ts] = x.w;
        }
      }
    } else {
      const MaskT* m = m0 + s * step_elems;
#pragma unroll
      for (int k = 0; k < kScalarLoads; ++k) {
        const int i = threadIdx.x + k * kThreads;   // (track, frame, frequency), frequency fastest
        if (i < n_stage) {
          const int fi = i % kStepFreqs;
          const int rest = i / kStepFreqs;
          buf[i] = to_float(m[(long long)(rest % T) * m_s_t + (long long)fi * m_s_f +
                              (long long)(rest / T) * m_s_c]);
        }
      }
    }
  }

  __device__ __forceinline__ void values(float (&v)[2][8]) {
    const float* buf = stage_s + (read % kStageBufs) * kStageFloats;
    ++read;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float4 mm = ok[r] ? *reinterpret_cast<const float4*>(buf + rd[r])
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      v[r][0] = rv[r].x * mm.x;
      v[r][1] = rv[r].y * mm.y;
      v[r][2] = rv[r].z * mm.z;
      v[r][3] = rv[r].w * mm.w;
      v[r][4] = iv[r].x * mm.x;
      v[r][5] = iv[r].y * mm.y;
      v[r][6] = iv[r].z * mm.z;
      v[r][7] = iv[r].w * mm.w;
    }
  }
};

template <int P, typename MaskT, bool kVec, bool kGeneral>
__global__ void __launch_bounds__(kThreads, 1) masked_istft_nhwc_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];

  const Rows rows(p.n_frames);
  const FwdBlock<kGeneral> blk(rows, p.n_tracks, p.n_freqs);
  const int T = blk.nt;   // the chunk's frames (the track's up to 128)

  Ring<P> ring;
  ring.init(smem);

  Loader<MaskT, kVec> ld;
  ld.col = 4 * (threadIdx.x % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int tl, t;
    ld.ok[r] = rows.at(frag_row(r), tl, t) && tl < blk.n_tr && t < T;
    if (!ld.ok[r]) tl = t = 0;
    ld.rd[r] = (tl * T + t) * kStepFreqs + ld.col;
    ld.re[r] = p.re + blk.bn * p.re_s_b + (long long)(blk.t0 + t) * p.re_s_t;
    ld.im[r] = p.im + blk.bn * p.im_s_b + (long long)(blk.t0 + t) * p.im_s_t;
  }
  ld.stage_s = reinterpret_cast<float*>(smem + kSmemBytes);
  ld.step_elems = kStepFreqs * p.m_s_f;
  ld.T = T;
  const MaskT* m0 = static_cast<const MaskT*>(p.mask) + blk.bn * p.m_s_b +
                    (long long)blk.t0 * p.m_s_t + (long long)blk.tr0 * p.m_s_c;
  if constexpr (kVec) {
    // piece i = ((group of 4 tracks) * T + frame) * 16 + frequency
    ld.n_stage = (blk.n_tr / kVecTracks) * T * kStepFreqs;
#pragma unroll
    for (int k = 0; k < kVecLoads; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int fi = i % kStepFreqs;
      const int t = (i / kStepFreqs) % T;
      const int grp = i / kStepFreqs / T;
      ld.mp[k] = m0 + (long long)t * p.m_s_t + (long long)fi * p.m_s_f + grp * kVecTracks;
      ld.wr[k] = ((grp * kVecTracks) * T + t) * kStepFreqs + fi;
    }
  } else {
    ld.n_stage = blk.n_tr * T * kStepFreqs;
    ld.m0 = m0;
    ld.m_s_t = p.m_s_t;
    ld.m_s_f = p.m_s_f;
    ld.m_s_c = p.m_s_c;
  }

  const int n_steps = p.n_freqs / kStepFreqs;
  ld.n_steps = n_steps;
  const size_t tile_bytes = (size_t)n_steps * form_bytes<P>();
  float acc[128];
  ring.gemm(acc, p.b_hi + blk.r_tile * tile_bytes, p.b_lo + blk.r_tile * tile_bytes, n_steps,
            ld);
  fwd_epilogue(acc, smem, rows, blk, p.n_freqs, p.out, p.n_tracks, p.out_len);
}

template <int P, typename MaskT, bool kGeneral>
void* pick_route(int vec) {
  return vec ? (void*)masked_istft_nhwc_kernel<P, MaskT, true, kGeneral>
             : (void*)masked_istft_nhwc_kernel<P, MaskT, false, kGeneral>;
}

template <int P, bool kGeneral>
void* pick_mask(int mask_is_bf16, int vec) {
  return mask_is_bf16 ? pick_route<P, __nv_bfloat16, kGeneral>(vec)
                      : pick_route<P, float, kGeneral>(vec);
}

template <int P>
void* pick(int mask_is_bf16, int vec, bool general) {
  return general ? pick_mask<P, true>(mask_is_bf16, vec) : pick_mask<P, false>(mask_is_bf16, vec);
}

}  // namespace

extern "C" {

// Launches K3 on `stream` (a cudaStream_t) of device `device`. re, im are
// (n_b, >= n_frames, n_freqs) float32, 16-byte aligned rows with a
// contiguous last axis; mask is (n_b, >= n_frames, n_freqs, n_tracks)
// float32 or bfloat16 with any element strides. precision: 0 bf16
// ("default"), 1 3xTF32 ("highest"); b_hi/b_lo the laid-out bases of that
// precision (ops/dft.py:mma_basis, kernel "fwd", K1's). `vec` picks the
// vector route: the tracks come in aligned groups of 4 (n_tracks and the
// tracks per pass multiples of 4, m_s_c 1, the other strides multiples of
// 4, the base aligned to 4 elements). out is (n_b, n_tracks,
// (n_frames - 3) * n_freqs / 4) float32, contiguous. Returns the
// cudaError_t of the launch (0 on success).
int sag_masked_istft_nhwc_fwd(const float* re, const float* im, const void* mask,
                              int mask_is_bf16, int precision, int vec, const void* b_hi,
                              const void* b_lo, float* out, int n_b, int n_tracks,
                              int n_frames, int n_freqs, long long re_s_b, long long re_s_t,
                              long long im_s_b, long long im_s_t, long long m_s_b,
                              long long m_s_t, long long m_s_f, long long m_s_c, int device,
                              void* stream) {
  if (n_b < 1 || n_tracks < 1 || n_frames < kOverlap || n_frames % kOverlap != 0 ||
      n_freqs < 32 || n_freqs % 32 != 0 ||
      (precision != kBF16 && precision != kTF32x3)) {
    return (int)cudaErrorInvalidValue;
  }
  const int per_pass = n_frames <= kTileRows ? (kTileRows / n_frames) * kWarpgroups : 1;
  const long long align = kVecTracks * (mask_is_bf16 ? 2 : 4);
  if (vec && (per_pass % kVecTracks != 0 || n_tracks % kVecTracks != 0 || m_s_c != 1 ||
              m_s_t % kVecTracks != 0 || m_s_f % kVecTracks != 0 ||
              (n_b > 1 && m_s_b % kVecTracks != 0) ||
              reinterpret_cast<uintptr_t>(mask) % align != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  Params p;
  p.re = re;
  p.im = im;
  p.mask = mask;
  p.b_hi = static_cast<const uint8_t*>(b_hi);
  p.b_lo = static_cast<const uint8_t*>(b_lo);
  p.out = out;
  p.n_tracks = n_tracks;
  p.n_frames = n_frames;
  p.n_freqs = n_freqs;
  p.out_len = (n_frames - (kOverlap - 1)) * (n_freqs / kOverlap);
  p.re_s_b = re_s_b;
  p.re_s_t = re_s_t;
  p.im_s_b = im_s_b;
  p.im_s_t = im_s_t;
  p.m_s_b = m_s_b;
  p.m_s_t = m_s_t;
  p.m_s_f = m_s_f;
  p.m_s_c = m_s_c;

  const long long n_blocks = fwd_blocks(n_b, n_tracks, n_frames, n_freqs);
  const bool general = fwd_general(n_frames, n_freqs);
  void* kernel = precision == kBF16 ? pick<kBF16>(mask_is_bf16, vec, general)
                                    : pick<kTF32x3>(mask_is_bf16, vec, general);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kNhwcSmemBytes);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchKernel(kernel, dim3((unsigned int)n_blocks), dim3(kThreads), args,
                         (size_t)kNhwcSmemBytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
