// Fused masked comb-ISTFT forward for Hopper (sm_90a), FP32 FFMA.
//
// Replaces the TPU kernel spatialaudiogen_tpu/ops/pallas_kernels.py:_kernel
// (launched by _forward, public API masked_istft_pallas). Per (b, in, track):
//
//   X[t, n]  = ((re*m)[t] @ C + (im*m)[t] @ S)[n] / F          n in [0, F)
//   out[p]   = 1/4 * sum of X[t, n] over (t, n) with (t - 3)*hop + n == p
//
// with hop = F/4, C/S the cos/sin DFT bases and p in [0, (T-3)*hop). Frame t
// of comb stream k = t % 4 starts at offset (3 - k)*hop, which is where the
// (t - 3)*hop above comes from. Writing n = q*hop + r (quarter q, residue r):
//
//   out[j*hop + r] = 1/4 * sum_{q=0..3} X[j + 3 - q, q*hop + r]
//
// so contributions collide only when their columns differ by a multiple of
// hop. A block therefore owns one (b, in) row, a group of tracks and a tile
// of 32 residues r; it computes X for every frame of its tracks at the 4*32
// columns {q*hop + r}, keeps that X tile in shared memory, and writes each
// output sample exactly once. No atomics, deterministic, one launch.
//
// What bounds it: per flagship window (32 tracks x 28 frames, F = 1024) the
// contraction is 2*F deep, about 3.8 GFLOP against about 4.7 MB of input and
// output, so it is bound by arithmetic, not by device memory. The design
// keeps the masked spectra out of device memory (the mask multiplies the
// A operand as it is staged into shared memory, which was the point of the
// TPU kernel too), stages A and B tiles through shared memory with a
// register prefetch of the next tile during the FFMA loop, and gives each
// thread an 8x8 register tile so every shared-memory read feeds 8 FMAs.
// The C/S bases (4 MB each) are read from L2. Tensor cores (wgmma with
// 3xTF32, or bf16 for pallas_precision="default") are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kOverlap = 4;
constexpr int RT = 32;                  // hop residues per block
constexpr int BN = kOverlap * RT;       // X columns per block: 4 quarters x 32 residues
constexpr int BM = 128;                 // A rows (track, frame) per row chunk
constexpr int BK = 16;                  // contraction depth per stage
constexpr int kThreads = 256;           // 16 x 16 threads, 8x8 accumulators each
constexpr int A_LD = BM + 4;            // A_s: k-major [BK][A_LD] (pad eases stores)
constexpr int B_LD = BN;                // B_s: k-major [BK][B_LD]
constexpr int X_LD = BN;                // X_s: row-major [rows][X_LD]

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
  int tracks_per_block;
  int out_len;
  long long re_s_bn, re_s_t;           // element strides; the F axis is contiguous
  long long im_s_bn, im_s_t;
  long long m_s_bn, m_s_tr, m_s_t;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(q[0]);
  const float2 hi = __bfloat1622float2(q[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Two blocks per SM: caps the kernel at 128 registers (a few bytes spill,
// against 155 registers and one block per SM without the cap), which ran
// about 20% faster on an H100 at the flagship shapes.
template <typename MaskT>
__global__ void __launch_bounds__(kThreads, 2)
masked_istft_fwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);   // [BK][A_LD]
  float* B_s = A_s + BK * A_LD;                   // [BK][B_LD]
  float* X_s = B_s + BK * B_LD;                   // [rows][X_LD]

  const int F = p.n_freqs;
  const int T = p.n_frames;
  const int hop = F / kOverlap;
  const int n_res = hop / RT;
  const int n_groups = (p.n_tracks + p.tracks_per_block - 1) / p.tracks_per_block;
  int blk = blockIdx.x;
  const int r0 = (blk % n_res) * RT;
  blk /= n_res;
  const int tr0 = (blk % n_groups) * p.tracks_per_block;
  const long long bn = blk / n_groups;
  const int n_tr = min(p.tracks_per_block, p.n_tracks - tr0);
  const int rows = n_tr * T;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const MaskT* mask = static_cast<const MaskT*>(p.mask);
  const int n_k_tiles = 2 * F / BK;   // k < F: re/C half, k >= F: im/S half

  // Staging map. A tile (BK x BM): thread loads 4 consecutive k of row
  // a_row[i] (a warp reads 8 rows x 64 contiguous bytes). B tile (BK x BN):
  // thread loads 4 consecutive columns (a warp reads 4 x 128 bytes of one
  // basis row).
  int a_row[2], a_k[2], b_k[2], b_col[2], b_n[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + kThreads * i;
    a_row[i] = idx >> 2;
    a_k[i] = (idx & 3) * 4;
    b_k[i] = idx >> 5;
    b_col[i] = (idx & 31) * 4;
    // column c = q*RT + rr of the tile is frequency n = q*hop + r0 + rr
    b_n[i] = (b_col[i] / RT) * hop + r0 + (b_col[i] % RT);
  }

  for (int row0 = 0; row0 < rows; row0 += BM) {
    const MaskT* m_ptr[2];
    const float* re_ptr[2];
    const float* im_ptr[2];
    bool a_ok[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + a_row[i];
      a_ok[i] = row < rows;
      const int tl = a_ok[i] ? row / T : 0;
      const int t = a_ok[i] ? row % T : 0;
      m_ptr[i] = mask + bn * p.m_s_bn + (long long)(tr0 + tl) * p.m_s_tr +
                 (long long)t * p.m_s_t + a_k[i];
      re_ptr[i] = p.re + bn * p.re_s_bn + (long long)t * p.re_s_t + a_k[i];
      im_ptr[i] = p.im + bn * p.im_s_bn + (long long)t * p.im_s_t + a_k[i];
    }

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    float4 pa[2], pb[2];   // next tile, prefetched into registers

    auto fetch = [&](int kt) {
      const int kbase = kt * BK;
      const bool imag = kbase >= F;
      const int f0 = imag ? kbase - F : kbase;
      const float* basis = imag ? p.sin_b : p.cos_b;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        if (a_ok[i]) {
          const float4 m = load4(m_ptr[i] + f0);
          const float4 s = load4((imag ? im_ptr[i] : re_ptr[i]) + f0);
          a = make_float4(s.x * m.x, s.y * m.y, s.z * m.z, s.w * m.w);
        }
        pa[i] = a;
        pb[i] = load4(basis + (long long)(f0 + b_k[i]) * F + b_n[i]);
      }
    };

    fetch(0);
    for (int kt = 0; kt < n_k_tiles; ++kt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float* a = A_s + a_k[i] * A_LD + a_row[i];
        a[0] = pa[i].x;
        a[A_LD] = pa[i].y;
        a[2 * A_LD] = pa[i].z;
        a[3 * A_LD] = pa[i].w;
        *reinterpret_cast<float4*>(B_s + b_k[i] * B_LD + b_col[i]) = pb[i];
      }
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

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + ty * 8 + i;
      if (row < rows) {
        *reinterpret_cast<float4*>(X_s + row * X_LD + tx * 4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(X_s + row * X_LD + 64 + tx * 4) =
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
    p.out[(bn * p.n_tracks + tr0 + tl) * p.out_len + j * hop + r0 + rr] = s * scale;
  }
}

}  // namespace

extern "C" {

// Shared memory one launch needs, in bytes.
long long sag_masked_istft_smem_bytes(int tracks_per_block, int n_frames) {
  return (long long)(BK * A_LD + BK * B_LD + (long long)tracks_per_block * n_frames * X_LD) *
         (long long)sizeof(float);
}

// Launches the kernel on `stream` (a cudaStream_t) of device `device`.
// out is (n_bn, n_tracks, (n_frames - 3) * n_freqs / 4) float32, contiguous.
// Returns the cudaError_t of the launch (0 on success).
int sag_masked_istft_fwd(const float* re, const float* im, const void* mask,
                         int mask_is_bf16, const float* cos_b, const float* sin_b,
                         float* out, int n_bn, int n_tracks, int n_frames,
                         int n_freqs, int tracks_per_block, long long re_s_bn,
                         long long re_s_t, long long im_s_bn, long long im_s_t,
                         long long m_s_bn, long long m_s_tr, long long m_s_t,
                         int device, void* stream) {
  if (n_bn < 1 || n_tracks < 1 || tracks_per_block < 1 || n_frames < kOverlap ||
      n_frames % kOverlap != 0 || n_freqs % (kOverlap * RT) != 0) {
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
  p.re_s_bn = re_s_bn;
  p.re_s_t = re_s_t;
  p.im_s_bn = im_s_bn;
  p.im_s_t = im_s_t;
  p.m_s_bn = m_s_bn;
  p.m_s_tr = m_s_tr;
  p.m_s_t = m_s_t;

  const long long n_groups = (n_tracks + tracks_per_block - 1) / tracks_per_block;
  const long long n_blocks = (long long)n_bn * n_groups * (n_freqs / kOverlap / RT);
  const long long smem = sag_masked_istft_smem_bytes(tracks_per_block, n_frames);
  void (*kernel)(const Params) = mask_is_bf16 ? masked_istft_fwd_kernel<__nv_bfloat16>
                                              : masked_istft_fwd_kernel<float>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned int)n_blocks, kThreads, (size_t)smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* sag_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
