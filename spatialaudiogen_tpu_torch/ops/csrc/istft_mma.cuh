// The tensor-core GEMM core shared by K1 (masked_istft.cu), K2
// (masked_istft_bwd.cu) and K3 (masked_istft_nhwc.cu) on Hopper (sm_90a).
//
// The kernels multiply an A operand that is built on the fly (the masked
// spectra in K1 and K3, the cotangent scattered onto the comb streams in
// K2) by a tile of the DFT bases, over 64-row tiles of (track, frame) rows
// and 256 basis columns. One block is two warpgroups; each owns one 64-row
// tile of a pass of 128 rows and the whole 64 x 256 f32 accumulator (128
// registers a thread). Per precision:
//
//   kBF16   ("default"): A and B rounded to bf16, wgmma.m64n256k16, f32
//           accumulation: one pass, the TPU's DEFAULT precision.
//   kTF32x3 ("highest"): 3xTF32. Each f32 operand x is split into
//           hi = tf32(x) (cvt.rna) and lo = tf32(x - hi); three
//           wgmma.m64n256k8 per k8 (a_hi b_hi + a_lo b_hi + a_hi b_lo) into
//           one f32 accumulator: f32-grade products.
//
// A lives in registers. A thread builds its own fragment (two rows, g and
// g + 8 of its warp's 16, four values of each per k16/k8 slice) from
// global memory, so the A operand never touches shared memory and needs no
// proxy fence: the staging that applies the mask (K1, K3) or the comb
// scatter and the 1/(4F) scale (K2) happens in registers, right before the
// conversion to bf16 or the tf32 split. Storing A to shared memory instead
// would buy nothing here: no other warpgroup reads a warpgroup's rows.
// K3's mask is the one input a thread cannot load as float4 along F: its
// loader stages the block's mask of a step through shared memory first
// (a loader with a stage() member, below).
//
// The k order inside a step is free as long as A and B agree, so a step
// covers 32 logical k that a thread loads as two float4 per row: slots
// v[0..3] and v[4..7]. A k16 bf16 wgmma h (h = 0, 1) takes logical
// k {2tig, 2tig+1} from v[2h], v[2h+1] and {2tig+8, 2tig+9} from v[4+2h],
// v[5+2h]; a k8 tf32 wgmma h (h = 0..3) takes k tig from v[h] and tig+4 from
// v[4+h] (tig = lane % 4). So slot (half, tig, j) of a step, half = 0 for
// v[0..3] and 1 for v[4..7], j the index inside the float4, is
//   K1: frequency 16 s + 4 tig + j of re*m (half 0, against C) or im*m
//       (half 1, against S): the mask value is loaded once for both;
//   K2: sample 32 s + 16 half + 4 tig + j of the frame.
//
// B is the matching basis tile, K-major (what tf32 wgmma requires; the
// bases are symmetric, so a column of B is a contiguous stretch of a basis
// row). ops/dft.py:mma_basis lays the bases out once per (F, device,
// kernel, form) in exactly the shared-memory image one step needs: per
// wgmma an 8 KB tile of 8 x 16-byte core matrices, no swizzle, core (nb, kc)
// (columns 8 nb .. 8 nb + 7, k chunk kc) at kc * kLBO + nb * kSBO. A step is
// therefore one contiguous copy, issued by one thread as a bulk TMA copy
// (cp.async.bulk) into a ring of stages completed on an mbarrier.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace istft_mma {

constexpr int kBF16 = 0;                   // pallas_precision="default"
constexpr int kTF32x3 = 1;                 // pallas_precision="highest"

constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kTileRows = 64;              // rows of one wgmma
constexpr int kPassRows = kTileRows * kWarpgroups;
constexpr int kN = 256;                    // columns of a block's GEMM
constexpr int kStepK = 32;                 // logical k per step
constexpr int kWgmmaBBytes = 8192;         // one wgmma's B: 256 columns x 32 bytes of k
constexpr int kLBO = 4096;                 // next 16-byte k chunk (core matrix along K)
constexpr int kSBO = 128;                  // next 8 columns (core matrix along N)
constexpr int kOutLD = kN + 8;             // f32 row stride of the block's output tile
constexpr int kOutBytes = kPassRows * kOutLD * 4;
constexpr int kRingBytes = 131072;         // the stage ring; the output tile aliases it

template <int P> struct Route;
template <> struct Route<kBF16> {
  static constexpr int kWgmmas = 2;        // k16 each
  static constexpr int kForms = 1;         // bf16
};
template <> struct Route<kTF32x3> {
  static constexpr int kWgmmas = 4;        // k8 each, three products
  static constexpr int kForms = 2;         // tf32 hi, tf32 lo
};
template <int P> __host__ __device__ constexpr int form_bytes() {
  return Route<P>::kWgmmas * kWgmmaBBytes;   // one step of one form
}
template <int P> __host__ __device__ constexpr int stage_bytes() {
  return Route<P>::kForms * form_bytes<P>();
}
template <int P> __host__ __device__ constexpr int ring_stages() {
  return kRingBytes / stage_bytes<P>();      // 8 (bf16) or 2 (3xTF32)
}

constexpr int kRegionBytes = kOutBytes > kRingBytes ? kOutBytes : kRingBytes;
constexpr int kSmemBytes = kRegionBytes + 8 * 8;   // + one mbarrier per stage (<= 8)

// ---------------------------------------------------------------------------
// PTX wrappers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One thread: arm `bar` for `bytes` and copy them (16-byte multiple) from
// global memory into shared memory with the bulk TMA engine.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a K-major tile without swizzle at shared address addr.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kLBO >> 4) << 16) |
         ((uint64_t)(kSBO >> 4) << 32);
}

// Orders this thread's earlier generic-proxy shared-memory accesses before
// later async-proxy ones (bulk copies into memory the epilogue used).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of these registers across the
// asynchronous wgmma window.
__device__ __forceinline__ void fence_regs(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

#define ISTFT_D8(i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define ISTFT_D128                                                                      \
  ISTFT_D8(0), ISTFT_D8(8), ISTFT_D8(16), ISTFT_D8(24), ISTFT_D8(32), ISTFT_D8(40),       \
      ISTFT_D8(48), ISTFT_D8(56), ISTFT_D8(64), ISTFT_D8(72), ISTFT_D8(80), ISTFT_D8(88), \
      ISTFT_D8(96), ISTFT_D8(104), ISTFT_D8(112), ISTFT_D8(120)
#define ISTFT_D128_STR                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127}"

// d += A (registers, m64k16 bf16) * B (shared memory, k16 x n256, K-major).
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " ISTFT_D128_STR
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : ISTFT_D128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d += A (registers, m64k8 tf32) * B (shared memory, k8 x n256, K-major).
__device__ __forceinline__ void wgmma_tf32(float (&d)[128], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 " ISTFT_D128_STR
      ", {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : ISTFT_D128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

#undef ISTFT_D8
#undef ISTFT_D128
#undef ISTFT_D128_STR

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// ---------------------------------------------------------------------------
// Vector loads and stores

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

// ---------------------------------------------------------------------------
// One step: the thread's A values v[row][slot] (rows g and g + 8) times the
// step's B image at shared address b (forms one after the other).

template <int P> struct Step;

template <> struct Step<kBF16> {
  __device__ __forceinline__ static void run(float (&acc)[128], const float (&v)[2][8],
                                             uint32_t b) {
    uint32_t a[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a[h][0] = pack_bf16(v[0][2 * h], v[0][2 * h + 1]);
      a[h][1] = pack_bf16(v[1][2 * h], v[1][2 * h + 1]);
      a[h][2] = pack_bf16(v[0][4 + 2 * h], v[0][5 + 2 * h]);
      a[h][3] = pack_bf16(v[1][4 + 2 * h], v[1][5 + 2 * h]);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h) wgmma_bf16(acc, a[h], b_desc(b + h * kWgmmaBBytes));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) fence_reg(a[h][i]);
  }
};

template <> struct Step<kTF32x3> {
  __device__ __forceinline__ static void run(float (&acc)[128], const float (&v)[2][8],
                                             uint32_t b) {
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float x[4] = {v[0][h], v[1][h], v[0][4 + h], v[1][4 + h]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hi[h][i] = tf32_rna(x[i]);
        lo[h][i] = tf32_rna(x[i] - __uint_as_float(hi[h][i]));
      }
    }
    const uint32_t b_lo = b + form_bytes<kTF32x3>();
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const uint64_t dh = b_desc(b + h * kWgmmaBBytes);
      wgmma_tf32(acc, hi[h], dh);
      wgmma_tf32(acc, lo[h], dh);
      wgmma_tf32(acc, hi[h], b_desc(b_lo + h * kWgmmaBBytes));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
#pragma unroll
    for (int h = 0; h < 4; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fence_reg(hi[h][i]);
        fence_reg(lo[h][i]);
      }
  }
};

// ---------------------------------------------------------------------------
// Block-level state: the stage ring in shared memory and its mbarriers.

// Whether a loader stages part of A through shared memory (has stage(s)).
template <class L, class = void> struct Staged : std::false_type {};
template <class L>
struct Staged<L, std::void_t<decltype(std::declval<L&>().stage(0))>> : std::true_type {};

template <int P> struct Ring {
  uint8_t* stages;       // ring_stages<P>() x stage_bytes<P>() bytes
  uint64_t* full;        // one mbarrier per stage
  uint32_t used = 0;     // steps run so far by this block (sets stage and parity)

  // Thread 0 of the block: the mbarriers, before any other thread uses them.
  __device__ void init(uint8_t* smem) {
    stages = smem;
    full = reinterpret_cast<uint64_t*>(smem + kRegionBytes);
    if (threadIdx.x == 0) {
      for (int i = 0; i < ring_stages<P>(); ++i) bar_init(&full[i], 1);
      bar_init_fence();
    }
    __syncthreads();
  }

  // Thread 0: bring step `s` of B (the forms at b_hi and b_lo) into the
  // stage of the block's k-th step.
  __device__ __forceinline__ void issue(const uint8_t* b_hi, const uint8_t* b_lo, int s,
                                        uint32_t k) {
    constexpr int FB = form_bytes<P>();
    uint8_t* dst = stages + (k % ring_stages<P>()) * stage_bytes<P>();
    uint64_t* bar = &full[k % ring_stages<P>()];
    bar_expect(bar, stage_bytes<P>());
    bulk_copy(dst, b_hi + (size_t)s * FB, FB, bar);
    if constexpr (Route<P>::kForms == 2) bulk_copy(dst + FB, b_lo + (size_t)s * FB, FB, bar);
  }

  // One GEMM pass: acc = A (the loader's rows) * B (n_steps steps of images
  // at b_hi / b_lo). The loader has `fetch(s)` (start the global loads of
  // step s) and `values(v)` (the A values of the fetched step). A loader
  // that stages part of A through shared memory (K3's mask) also has
  // `stage(s)`, which writes step s's part there: gemm calls it for steps
  // 0 and 1 before the loop and for step s + 2 right after the barrier
  // that ends step s, so a thread still waiting on its loads never holds
  // up that barrier, and the next one publishes the part a step before
  // its values() (the loader keeps three buffers). On return every thread
  // of the block is done with the ring, so the caller may reuse its
  // memory (the output tile aliases it) until the next gemm.
  template <class Loader>
  __device__ __forceinline__ void gemm(float (&acc)[128], const uint8_t* b_hi,
                                       const uint8_t* b_lo, int n_steps, Loader& ld) {
    constexpr int NS = ring_stages<P>();
    constexpr bool kStaged = Staged<Loader>::value;
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    fence_proxy_async();
    __syncthreads();   // the previous pass's epilogue is done with the ring's memory
    if (threadIdx.x == 0) {
      for (int s = 0; s < NS && s < n_steps; ++s) issue(b_hi, b_lo, s, used + s);
    }
    if constexpr (kStaged) ld.stage(0);
    ld.fetch(0);
    if constexpr (kStaged) {
      if (n_steps > 1) ld.stage(1);
      __syncthreads();
    }
    for (int s = 0; s < n_steps; ++s) {
      const uint32_t k = used + s;
      float v[2][8];
      ld.values(v);
      if (s + 1 < n_steps) ld.fetch(s + 1);   // in flight during the MMAs
      bar_wait(&full[k % NS], (k / NS) & 1);
      __syncwarp();
      Step<P>::run(acc, v, smem_u32(stages + (k % NS) * stage_bytes<P>()));
      __syncthreads();   // both warpgroups are done with this stage
      if (threadIdx.x == 0 && s + NS < n_steps) issue(b_hi, b_lo, s + NS, k + NS);
      if constexpr (kStaged) {
        if (s + 2 < n_steps) ld.stage(s + 2);
      }
    }
    used += n_steps;
  }
};

// ---------------------------------------------------------------------------
// Rows. A pass holds whole tracks: with T <= 64 frames, each 64-row tile
// holds floor(64 / T) tracks (its last rows are padding); with
// 64 < T <= 128, one track fills the pass; longer tracks are split into
// chunks of at most 128 frames, one track per pass (fwd_chunks for K1 and
// K3, plain 128-frame chunks for K2).

struct Rows {
  int T;             // frames
  int per_tile;      // tracks per 64-row tile (0: one track per pass)
  int per_pass;      // tracks per pass

  __device__ __forceinline__ explicit Rows(int n_frames) : T(n_frames) {
    per_tile = n_frames <= kTileRows ? kTileRows / n_frames : 0;
    per_pass = per_tile ? per_tile * kWarpgroups : 1;
  }

  // pass row of (track tl of the pass, frame tt of the pass's chunk)
  __device__ __forceinline__ int row(int tl, int tt) const {
    return per_tile ? (tl / per_tile) * kTileRows + (tl % per_tile) * T + tt : tt;
  }

  // (track of the pass, frame of the chunk) of pass row p; false for padding
  __device__ __forceinline__ bool at(int p, int& tl, int& tt) const {
    if (per_tile) {
      const int i = p % kTileRows;
      tl = (p / kTileRows) * per_tile + i / T;
      tt = i % T;
      return i < per_tile * T;
    }
    tl = 0;
    tt = p;
    return true;
  }
};

// The two pass rows a thread's fragment covers: g and g + 8 of its warp's
// 16 rows of its warpgroup's 64.
__device__ __forceinline__ int frag_row(int r) {
  const int t = threadIdx.x;
  return (t / 128) * kTileRows + ((t % 128) / 32) * 16 + (t % 32) / 4 + 8 * r;
}

// ---------------------------------------------------------------------------
// The forward (K1, K3). Frame t of comb stream k = t % 4 starts at offset
// (3 - k)*hop, hop = F/4; writing a column n = q*hop + r (quarter q,
// residue r),
//
//   out[j*hop + r] = 1/4 * sum_{q=0..3} X[j + 3 - q, q*hop + r]
//
// so contributions collide only when their columns differ by a multiple of
// hop. A block owns one row of the flattened batch, the tracks of one pass,
// a chunk of frames and a tile of up to kResidues residues r: it computes X
// for every frame of its chunk at the 4 * kResidues = kN columns
// {q*hop + r}, one GEMM of depth 2F, keeps that X tile in shared memory and
// writes each output sample exactly once. No atomics, deterministic, one
// launch.
//
// Small F: with hop < kResidues (F < 256) the tile has hop residues and the
// basis image's other columns are zero (ops/dft.py:mma_basis); F needs only
// be a multiple of 32, so a last tile may be partial too.
//
// Long tracks (T > 128): output j needs frames j .. j + 3, so the chunks
// overlap by 3 frames. Chunk c covers outputs [c*outs, (c+1)*outs) and frames
// [c*outs, (c+1)*outs + 3), at most 128: each chunk recomputes the 3 frames
// it shares with the next (2.4% more rows at 128-frame chunks) instead of
// carrying the seam's partial sums, so chunks are independent blocks and
// every sum keeps the order of the one-pass case. For T <= 128 there is one
// chunk, the whole track.
//
// Both cases are a template branch (kGeneral, fwd_general): the flagship's
// shapes (F a multiple of 256, T <= 128) compile to the code without them,
// as the guards cost its batch-128 launch 4% when they were always there.

constexpr int kOverlap = 4;
constexpr int kResidues = kN / kOverlap;   // hop residues per block, at most
constexpr int kChunkOuts = kPassRows - (kOverlap - 1);   // outputs per chunk, at most

// Chunks of a track of n_frames used frames: n of them, `outs` outputs each
// (the last may have fewer).
__host__ __device__ inline void fwd_chunks(int n_frames, int& n, int& outs) {
  const int n_out = n_frames - (kOverlap - 1);
  n = (n_out + kChunkOuts - 1) / kChunkOuts;
  outs = (n_out + n - 1) / n;
}

__host__ __device__ inline int fwd_res_tiles(int n_freqs) {
  return (n_freqs / kOverlap + kResidues - 1) / kResidues;
}

// Whether a forward launch needs the general block: small F, a partial
// residue tile or chunked tracks.
inline bool fwd_general(int n_frames, int n_freqs) {
  return n_frames > kPassRows || n_freqs % kN != 0;
}

template <bool kGeneral> struct FwdBlock {
  int r_tile;        // residue tile
  int n_res;         // residues in it
  int tr0, n_tr;     // first track of the pass, tracks in it
  int t0, nt;        // first frame of the chunk, frames in it
  long long bn;      // row of the flattened batch

  __device__ __forceinline__ FwdBlock(const Rows& rows, int n_tracks, int n_freqs) {
    const int n_rt = fwd_res_tiles(n_freqs);
    const int n_groups = (n_tracks + rows.per_pass - 1) / rows.per_pass;
    int blk = blockIdx.x;
    r_tile = blk % n_rt;
    blk /= n_rt;
    if constexpr (kGeneral) {
      int n_chunks, outs;
      fwd_chunks(rows.T, n_chunks, outs);
      const int chunk = blk % n_chunks;
      blk /= n_chunks;
      n_res = min(kResidues, n_freqs / kOverlap - r_tile * kResidues);
      t0 = chunk * outs;
      nt = min(outs, rows.T - (kOverlap - 1) - t0) + (kOverlap - 1);
    } else {
      n_res = kResidues;
      t0 = 0;
      nt = rows.T;
    }
    tr0 = (blk % n_groups) * rows.per_pass;
    bn = blk / n_groups;
    n_tr = min(rows.per_pass, n_tracks - tr0);
  }
};

// Blocks of one forward launch (FwdBlock's order: residue tile fastest,
// then chunk).
inline long long fwd_blocks(int n_bn, int n_tracks, int n_frames, int n_freqs) {
  const int per_pass = n_frames <= kTileRows ? (kTileRows / n_frames) * kWarpgroups : 1;
  const long long n_groups = (n_tracks + per_pass - 1) / per_pass;
  int n_chunks, outs;
  fwd_chunks(n_frames, n_chunks, outs);
  return (long long)n_bn * n_groups * n_chunks * fwd_res_tiles(n_freqs);
}

// The epilogue: the accumulators (X, unscaled) into the X tile at the start
// of shared memory (it aliases the ring, free once gemm returns), then the
// comb overlap-add of the block's tracks into out, (n_bn, n_tracks,
// out_len), scaled by 1/(4F). A warp handles 32 consecutive residues:
// conflict-free shared reads and one 128-byte store.
template <bool kGeneral>
__device__ __forceinline__ void fwd_epilogue(const float (&acc)[128], uint8_t* smem,
                                             const Rows& rows, const FwdBlock<kGeneral>& blk,
                                             int F, float* out, int n_tracks, int out_len) {
  float* X_s = reinterpret_cast<float*>(smem);   // [kPassRows][kOutLD]
  // thread holds rows frag_row(0/1), columns 8 j + 2 tig + (0, 1)
  const int tig = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* x = X_s + frag_row(r) * kOutLD + 2 * tig;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
      store2(x + 8 * j, make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]));
  }
  __syncthreads();

  const int hop = F / kOverlap;
  const float scale = 1.f / (float(kOverlap) * float(F));
  const int n_j = blk.nt - (kOverlap - 1);
  const int total = blk.n_tr * n_j * kResidues;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int rr = idx % kResidues;
    if constexpr (kGeneral) {
      if (rr >= blk.n_res) continue;   // the zero columns of a small or last tile
    }
    const int rest = idx / kResidues;
    const int j = rest % n_j;
    const int tl = rest / n_j;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kOverlap; ++q)
      s += X_s[rows.row(tl, j + kOverlap - 1 - q) * kOutLD + q * kResidues + rr];
    out[(blk.bn * n_tracks + blk.tr0 + tl) * out_len + (blk.t0 + j) * hop +
        blk.r_tile * kResidues + rr] = s * scale;
  }
}

}  // namespace istft_mma
