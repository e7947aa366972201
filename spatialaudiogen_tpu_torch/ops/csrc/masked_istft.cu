// Fused masked comb-ISTFT forward (K1) for Hopper (sm_90a), on the tensor
// cores through wgmma (istft_mma.cuh): bf16 for pallas_precision="default",
// 3xTF32 for "highest".
//
// Replaces the TPU kernel spatialaudiogen_tpu/ops/pallas_kernels.py:_kernel
// (launched by _forward, public API masked_istft_pallas). Per (b, in, track):
//
//   X[t, n]  = ((re*m)[t] @ C + (im*m)[t] @ S)[n] / F          n in [0, F)
//   out[p]   = 1/4 * sum of X[t, n] over (t, n) with (t - 3)*hop + n == p
//
// with hop = F/4, C/S the cos/sin DFT bases and p in [0, (T-3)*hop). Frame t
// of comb stream k = t % 4 starts at offset (3 - k)*hop, which is where the
// (t - 3)*hop above comes from. A block (istft_mma.cuh: FwdBlock,
// fwd_epilogue) owns one (b, in) row, the tracks of one 128-row pass (4
// tracks at T = 28: two per 64-row warpgroup tile, 8 padding rows each; one
// track at 64 < T <= 128), a chunk of frames (the whole track up to
// T = 128; longer tracks in chunks of at most 128 frames that overlap by 3)
// and a tile of 64 hop residues r (hop of them when F < 256): it computes X
// for every frame of its chunk at the 4*64 = 256 columns {q*hop + r}, one
// GEMM of depth 2F, keeps that X tile in shared memory and writes each
// output sample exactly once. No atomics, deterministic, one launch. Any T,
// any F that is a multiple of 32.
//
// The GEMM (istft_mma.cuh): A = [re*m | im*m] built in registers from
// global memory, the mask multiplying each value as it is staged, so the
// masked spectra never reach device memory (the point of the TPU kernel
// too). A step is 16 frequencies: one float4 of the mask, re and im per row
// feeds both halves (re*m against C, im*m against S), so each mask value is
// loaded once per block. B is the step's tile of [C; S] at the block's
// 256 columns, laid out once per (F, device, form) by ops/dft.py:mma_basis
// and copied whole by the bulk TMA engine into a ring of stages.
//
// What bounds it on an H100 (batch 16 at the flagship: 16 x 32 tracks x
// 28 frames, F = 1024): 60.1 GFLOP; 58.7 MB of f32 mask (29.4 MB bf16),
// 3.7 MB of spectra and a 13.1 MB output. "default" (bf16, 989 TFLOP/s):
// 0.061 ms of operations against 0.023 ms of bytes, so operations bound it.
// "highest" (3xTF32, three passes at 495 TFLOP/s): 0.364 ms. What one call
// moves beyond that: each block reads its tracks' mask once per residue
// tile (4 tiles at F = 1024; the tiles of one track group are neighbouring
// blocks, so the repeats hit L2), and 1 MB (bf16; 4 MB for 3xTF32) of basis
// tile per block from L2, 512 MB (2 GB) in all at batch 16: the largest
// traffic of the kernel, served by L2, which holds the 4 MB (16 MB) of
// laid-out bases.

#include "istft_mma.cuh"

namespace {

using namespace istft_mma;

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
  long long re_s_bn, re_s_t;           // element strides; the F axis is contiguous
  long long im_s_bn, im_s_t;
  long long m_s_bn, m_s_tr, m_s_t;
};

// A mask vector of 4 values as loaded (converted to f32 where it is used, so
// the load stays in flight across the step before).
template <typename MaskT> struct Mask4;
template <> struct Mask4<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) { v = load4(p); }
  __device__ __forceinline__ void zero() { v = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ float4 get() const { return v; }
};
template <> struct Mask4<__nv_bfloat16> {
  uint2 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ void zero() { v = make_uint2(0u, 0u); }
  __device__ __forceinline__ float4 get() const {
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
};

// The A values of the thread's two rows: v[0..3] = re*m and v[4..7] = im*m
// at frequencies 16 s + 4 tig + (0..3).
template <typename MaskT> struct Loader {
  const MaskT* m[2];
  const float* re[2];
  const float* im[2];
  bool ok[2];
  int col;
  Mask4<MaskT> mv[2];
  float4 rv[2], iv[2];

  __device__ __forceinline__ void fetch(int s) {
    const int f = 16 * s + col;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (ok[r]) {
        mv[r].load(m[r] + f);
        rv[r] = load4(re[r] + f);
        iv[r] = load4(im[r] + f);
      } else {
        mv[r].zero();
        rv[r] = iv[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }

  __device__ __forceinline__ void values(float (&v)[2][8]) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float4 mm = mv[r].get();
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

template <int P, typename MaskT, bool kGeneral>
__global__ void __launch_bounds__(kThreads, 1) masked_istft_fwd_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];

  const Rows rows(p.n_frames);
  const FwdBlock<kGeneral> blk(rows, p.n_tracks, p.n_freqs);

  Ring<P> ring;
  ring.init(smem);

  const MaskT* mask = static_cast<const MaskT*>(p.mask);
  Loader<MaskT> ld;
  ld.col = 4 * (threadIdx.x % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int tl, t;
    ld.ok[r] = rows.at(frag_row(r), tl, t) && tl < blk.n_tr && t < blk.nt;
    if (!ld.ok[r]) tl = t = 0;
    t += blk.t0;
    ld.m[r] = mask + blk.bn * p.m_s_bn + (long long)(blk.tr0 + tl) * p.m_s_tr +
              (long long)t * p.m_s_t;
    ld.re[r] = p.re + blk.bn * p.re_s_bn + (long long)t * p.re_s_t;
    ld.im[r] = p.im + blk.bn * p.im_s_bn + (long long)t * p.im_s_t;
  }

  const int n_steps = p.n_freqs / 16;
  const size_t tile_bytes = (size_t)n_steps * form_bytes<P>();
  float acc[128];
  ring.gemm(acc, p.b_hi + blk.r_tile * tile_bytes, p.b_lo + blk.r_tile * tile_bytes, n_steps,
            ld);
  fwd_epilogue(acc, smem, rows, blk, p.n_freqs, p.out, p.n_tracks, p.out_len);
}

template <int P, bool kGeneral>
void* pick_mask(int mask_is_bf16) {
  return mask_is_bf16 ? (void*)masked_istft_fwd_kernel<P, __nv_bfloat16, kGeneral>
                      : (void*)masked_istft_fwd_kernel<P, float, kGeneral>;
}

template <int P>
void* pick(int mask_is_bf16, bool general) {
  return general ? pick_mask<P, true>(mask_is_bf16) : pick_mask<P, false>(mask_is_bf16);
}

}  // namespace

extern "C" {

// Shared memory one launch needs, in bytes (the same for both precisions).
long long sag_masked_istft_smem_bytes() { return kSmemBytes; }

// Launches the kernel on `stream` (a cudaStream_t) of device `device`.
// precision: 0 bf16 ("default"), 1 3xTF32 ("highest"); b_hi/b_lo the laid-out
// bases of that precision (ops/dft.py:mma_basis, kernel "fwd"). out is
// (n_bn, n_tracks, (n_frames - 3) * n_freqs / 4) float32, contiguous.
// Returns the cudaError_t of the launch (0 on success).
int sag_masked_istft_fwd(const float* re, const float* im, const void* mask,
                         int mask_is_bf16, int precision, const void* b_hi, const void* b_lo,
                         float* out, int n_bn, int n_tracks, int n_frames, int n_freqs,
                         long long re_s_bn, long long re_s_t, long long im_s_bn,
                         long long im_s_t, long long m_s_bn, long long m_s_tr,
                         long long m_s_t, int device, void* stream) {
  if (n_bn < 1 || n_tracks < 1 || n_frames < kOverlap || n_frames % kOverlap != 0 ||
      n_freqs < 32 || n_freqs % 32 != 0 ||
      (precision != kBF16 && precision != kTF32x3)) {
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
  p.re_s_bn = re_s_bn;
  p.re_s_t = re_s_t;
  p.im_s_bn = im_s_bn;
  p.im_s_t = im_s_t;
  p.m_s_bn = m_s_bn;
  p.m_s_tr = m_s_tr;
  p.m_s_t = m_s_t;

  const long long n_blocks = fwd_blocks(n_bn, n_tracks, n_frames, n_freqs);
  const bool general = fwd_general(n_frames, n_freqs);
  void* kernel = precision == kBF16 ? pick<kBF16>(mask_is_bf16, general)
                                    : pick<kTF32x3>(mask_is_bf16, general);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchKernel(kernel, dim3((unsigned int)n_blocks), dim3(kThreads), args,
                         (size_t)kSmemBytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* sag_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
