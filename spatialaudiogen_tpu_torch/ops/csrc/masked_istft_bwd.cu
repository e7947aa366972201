// Backward of the fused masked comb-ISTFT for Hopper (sm_90a), FP32 FFMA.
//
// Replaces the TPU kernel spatialaudiogen_tpu/ops/pallas_kernels.py:_bwd_kernel
// (launched by _backward_pallas, the custom VJP of masked_istft_pallas).
// The forward (masked_istft.cu) maps frame t, column n of a track to output
// sample p = (t - 3)*hop + n. Its backward, for one (b, in) row, per track r:
//
//   gx[r, t, n]   = g[r, (t - 3)*hop + n] / (4F)      (0 outside [0, out_len))
//   g_rm[r, t, f] = sum_n gx[r, t, n] C[n, f]          (C, S symmetric: no transpose)
//   g_im[r, t, f] = sum_n gx[r, t, n] S[n, f]
//   d_mask[r, t, f] = g_rm * re[t, f] + g_im * im[t, f]        (mask dtype)
//   d_re[t, f]      = sum_r g_rm * m[r, t, f]
//   d_im[t, f]      = sum_r g_im * m[r, t, f]
//
// Design. A block owns one (b, in) row and a tile of FT = 64 output
// frequencies f, and loops over ALL tracks, so the track sums of d_re/d_im
// stay on chip: no atomics, one store each, deterministic. The two GEMMs
// share their A operand (gx), so a block computes them as one GEMM against
// B = [C[:, f-tile] | S[:, f-tile]] (128 columns). A is gathered straight
// from g while it is staged into shared memory (gx never reaches device
// memory); the row space (track, frame) is walked in chunks of at most
// BM = 128 rows made of whole tracks (or, for more than 128 frames, of one
// track's frames). Per chunk the epilogue writes d_mask from registers and
// parks g_rm*m and g_im*m in shared memory; a fixed-order pass then sums
// them over the chunk's tracks into a per-block (frame, column) accumulator
// in shared memory, which is written once at the end.
//
// What bounds it: per flagship window (32 tracks x 28 frames, F = 1024) the
// GEMM is 896 x 1024 x 2048 = 3.8 GFLOP against about 7.5 MB of input and
// output (the mask read and d_mask written dominate), so it is bound by
// arithmetic. The inner loop is K1's: A and B tiles staged through shared
// memory with a register prefetch of the next tile, and an 8x8 register
// tile per thread (8 rows x 4 columns of each of g_rm and g_im), so every
// shared-memory read feeds 8 FMAs. The bases are read from L2. Skipping the
// zero rows of g outside the model's output crop, and tensor cores, are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kOverlap = 4;
constexpr int FT = 64;                  // output frequencies per block
constexpr int BN = 2 * FT;              // GEMM columns: FT of C, then FT of S
constexpr int BM = 128;                 // A rows (track, frame) per chunk
constexpr int BK = 16;                  // contraction depth per stage
constexpr int kThreads = 256;           // 16 x 16 threads, 8x8 accumulators each
constexpr int A_LD = BM + 4;            // A_s: k-major [BK][A_LD]
constexpr int B_LD = BN;                // B_s: k-major [BK][B_LD]
constexpr int P_LD = BN;                // P_s: row-major [BM][P_LD]
constexpr int D_LD = BN;                // D_s: row-major [frames][D_LD]

struct Params {
  const float* g;          // (n_bn, n_tracks, out_len), contiguous
  const float* re;
  const float* im;
  const void* mask;
  const float* cos_b;
  const float* sin_b;
  void* d_mask;            // (n_bn, n_tracks, n_frames_total, F), contiguous
  float* d_re;             // (n_bn, n_frames_total, F), contiguous
  float* d_im;
  int n_tracks;
  int n_frames;            // frames used (a multiple of 4)
  int n_frames_total;      // frames of the outputs (>= n_frames)
  int n_freqs;             // F, a multiple of FT (so hop and out_len are multiples of 16)
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

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}

template <typename MaskT>
__global__ void __launch_bounds__(kThreads, 2)
masked_istft_bwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* A_s = reinterpret_cast<float*>(smem4);   // [BK][A_LD]
  float* B_s = A_s + BK * A_LD;                   // [BK][B_LD]
  float* P_s = B_s + BK * B_LD;                   // [BM][P_LD]
  float* D_s = P_s + BM * P_LD;                   // [n_frames][D_LD]

  const int F = p.n_freqs;
  const int T = p.n_frames;
  const int hop = F / kOverlap;
  const int n_ftiles = F / FT;
  const int f0 = (blockIdx.x % n_ftiles) * FT;
  const long long bn = blockIdx.x / n_ftiles;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const MaskT* mask = static_cast<const MaskT*>(p.mask);
  MaskT* d_mask = static_cast<MaskT*>(p.d_mask);
  const float* g_row = p.g + bn * p.n_tracks * (long long)p.out_len;
  const float scale = 1.f / (float(kOverlap) * float(F));
  const int n_k_tiles = F / BK;

  for (int i = tid; i < T * D_LD; i += kThreads) D_s[i] = 0.f;

  // Chunks: whole tracks when a track's frames fit in BM rows, else one
  // track's frames BM at a time. Row `row` of a chunk is
  // (track r0 + row / nt, frame t0 + row % nt).
  const int frames_per_chunk = T < BM ? T : BM;
  const int tracks_per_chunk = T < BM ? BM / T : 1;

  // Staging map (as in masked_istft.cu). A tile (BK x BM): thread loads 4
  // consecutive k of row a_row[i]. B tile (BK x BN): thread loads 4
  // consecutive columns of one basis row; columns [0, FT) come from C,
  // [FT, BN) from S.
  int a_row[2], a_k[2], b_k[2], b_col[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + kThreads * i;
    a_row[i] = idx >> 2;
    a_k[i] = (idx & 3) * 4;
    b_k[i] = idx >> 5;
    b_col[i] = (idx & 31) * 4;
  }

  for (int r0 = 0; r0 < p.n_tracks; r0 += tracks_per_chunk) {
    const int ntr = min(tracks_per_chunk, p.n_tracks - r0);
    for (int t0 = 0; t0 < T; t0 += frames_per_chunk) {
      const int nt = min(frames_per_chunk, T - t0);
      const int rows = ntr * nt;

      // A row -> first output sample p0 of its frame (may be negative)
      const float* g_ptr[2];
      int p0[2];
      bool a_ok[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = a_row[i];
        a_ok[i] = row < rows;
        const int r = r0 + (a_ok[i] ? row / nt : 0);
        const int t = t0 + (a_ok[i] ? row % nt : 0);
        g_ptr[i] = g_row + (long long)r * p.out_len;
        p0[i] = (t - (kOverlap - 1)) * hop + a_k[i];
      }

      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

      float4 pa[2], pb[2];   // next tile, prefetched into registers

      auto fetch = [&](int kt) {
        const int n0 = kt * BK;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // out_len and the sample offsets are multiples of 4, so a float4
          // of g lies wholly inside or wholly outside [0, out_len)
          const int s = p0[i] + n0;
          float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
          if (a_ok[i] && s >= 0 && s < p.out_len) {
            const float4 v = load4(g_ptr[i] + s);
            a = make_float4(v.x * scale, v.y * scale, v.z * scale, v.w * scale);
          }
          pa[i] = a;
          const float* basis = b_col[i] < FT ? p.cos_b : p.sin_b;
          pb[i] = load4(basis + (long long)(n0 + b_k[i]) * F + f0 + (b_col[i] % FT));
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
          store4(B_s + b_k[i] * B_LD + b_col[i], pb[i]);
        }
        __syncthreads();
        if (kt + 1 < n_k_tiles) fetch(kt + 1);   // in flight during the FMAs
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          const float4 a0 = *reinterpret_cast<const float4*>(A_s + kk * A_LD + ty * 8);
          const float4 a1 = *reinterpret_cast<const float4*>(A_s + kk * A_LD + ty * 8 + 4);
          const float4 b0 = *reinterpret_cast<const float4*>(B_s + kk * B_LD + tx * 4);
          const float4 b1 = *reinterpret_cast<const float4*>(B_s + kk * B_LD + FT + tx * 4);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }

      // Epilogue: thread (ty, tx) holds rows ty*8 + i, columns f0 + tx*4 + j
      // of g_rm (acc[i][j]) and g_im (acc[i][4 + j]).
      const int f = f0 + tx * 4;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = ty * 8 + i;
        if (row < rows) {
          const int r = r0 + row / nt;
          const int t = t0 + row % nt;
          const float4 re = load4(p.re + bn * p.re_s_bn + (long long)t * p.re_s_t + f);
          const float4 im = load4(p.im + bn * p.im_s_bn + (long long)t * p.im_s_t + f);
          const float4 m = load4(mask + bn * p.m_s_bn + (long long)r * p.m_s_tr +
                                 (long long)t * p.m_s_t + f);
          const float4 dm = make_float4(acc[i][0] * re.x + acc[i][4] * im.x,
                                        acc[i][1] * re.y + acc[i][5] * im.y,
                                        acc[i][2] * re.z + acc[i][6] * im.z,
                                        acc[i][3] * re.w + acc[i][7] * im.w);
          store4(d_mask + ((bn * p.n_tracks + r) * p.n_frames_total + t) * (long long)F + f,
                 dm);
          store4(P_s + row * P_LD + tx * 4,
                 make_float4(acc[i][0] * m.x, acc[i][1] * m.y, acc[i][2] * m.z,
                             acc[i][3] * m.w));
          store4(P_s + row * P_LD + FT + tx * 4,
                 make_float4(acc[i][4] * m.x, acc[i][5] * m.y, acc[i][6] * m.z,
                             acc[i][7] * m.w));
        }
      }
      __syncthreads();

      // Track sum of this chunk, in a fixed order: element (tt, c) is
      // always handled by the same thread, so the result is deterministic.
      for (int idx = tid; idx < nt * BN; idx += kThreads) {
        const int c = idx % BN;
        const int tt = idx / BN;
        float s = 0.f;
        for (int tl = 0; tl < ntr; ++tl) s += P_s[(tl * nt + tt) * P_LD + c];
        D_s[(t0 + tt) * D_LD + c] += s;
      }
      __syncthreads();
    }
  }

  for (int idx = tid; idx < T * BN; idx += kThreads) {
    const int c = idx % BN;
    const int t = idx / BN;
    float* dst = c < FT ? p.d_re : p.d_im;
    dst[(bn * p.n_frames_total + t) * (long long)F + f0 + (c % FT)] = D_s[t * D_LD + c];
  }
}

}  // namespace

extern "C" {

// Shared memory one launch needs, in bytes.
long long sag_masked_istft_bwd_smem_bytes(int n_frames) {
  return (long long)(BK * A_LD + BK * B_LD + BM * P_LD + (long long)n_frames * D_LD) *
         (long long)sizeof(float);
}

// Launches the kernel on `stream` (a cudaStream_t) of device `device`.
// g is (n_bn, n_tracks, (n_frames - 3) * n_freqs / 4) float32, contiguous;
// d_mask (mask dtype), d_re and d_im are contiguous with n_frames_total
// frames, of which the kernel writes the first n_frames.
// Returns the cudaError_t of the launch (0 on success).
int sag_masked_istft_bwd(const float* g, const float* re, const float* im,
                         const void* mask, int mask_is_bf16, const float* cos_b,
                         const float* sin_b, void* d_mask, float* d_re, float* d_im,
                         int n_bn, int n_tracks, int n_frames, int n_frames_total,
                         int n_freqs, long long re_s_bn, long long re_s_t,
                         long long im_s_bn, long long im_s_t, long long m_s_bn,
                         long long m_s_tr, long long m_s_t, int device, void* stream) {
  if (n_bn < 1 || n_tracks < 1 || n_frames < kOverlap || n_frames % kOverlap != 0 ||
      n_frames_total < n_frames || n_freqs % FT != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;

  Params p;
  p.g = g;
  p.re = re;
  p.im = im;
  p.mask = mask;
  p.cos_b = cos_b;
  p.sin_b = sin_b;
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

  const long long n_blocks = (long long)n_bn * (n_freqs / FT);
  const long long smem = sag_masked_istft_bwd_smem_bytes(n_frames);
  void (*kernel)(const Params) = mask_is_bf16 ? masked_istft_bwd_kernel<__nv_bfloat16>
                                              : masked_istft_bwd_kernel<float>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned int)n_blocks, kThreads, (size_t)smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
