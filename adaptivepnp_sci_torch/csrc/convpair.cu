// Fused CvBlock conv pair (3x3 conv -> scale/shift -> ReLU, twice) in bf16 on
// the tensor cores, for Hopper (sm_90a).
//
// Replaces: scripts/ab_pallas_convpair.py, _convpair_kernel (pallas_call in
// pallas_convpair).
//
// Computes, for x (N, H, W, C) bf16, kernels w1, w2 (3, 3, C, C) bf16 laid out
// [tap][cin][cout], and float32 s1, b1, s2, b2 of C elements:
//     h   = bf16( relu( s1 * conv3x3(x, w1) + b1 ) )     zero outside the image
//     out = bf16( relu( s2 * conv3x3(h, w2) + b2 ) )
// Both convolutions are zero-padded by 1. Products are summed in float32; the
// scale, shift and ReLU run on the float32 sums. The intermediate h never
// leaves the SM: device memory sees one read of x and one write of out.
//
// What bounds it on this card: operations. A pair at N = 8, C = 64, 256x256
// is 77 GFLOP against 134 MB, 580 flop per byte, above the ~295 flop/byte
// where the bf16 tensor cores (989 TFLOP/s) overtake HBM3 (3.35 TB/s).
//
// What the design does about it, as a simple version that uses the tensor
// cores: one block of 8 warps per (TH, TW) output tile. The block holds the
// (TH+4, TW+4) halo tile of x and the (TH+2, TW+2) tile of h in shared memory
// with channels innermost, and both convolutions are implicit GEMMs over that
// memory, nine taps each, with mma.sync m16n8k16 bf16 instructions, float32
// accumulators in registers, and ldmatrix loads. Pixels are numbered along
// the tile's pitch PW = TW + 4, so a tap is a constant offset in that
// numbering and an A fragment is 16 consecutive pixels wherever a row ends;
// the few columns that wrap around are computed and never used. A pixel's
// channels are padded by 8 (16 bytes), which keeps every ldmatrix row aligned
// and spreads eight rows over all banks. Each warp keeps its M fragments
// times all C/8 N tiles in accumulators (128 registers) across the nine
// taps; the inner loop has no branch (a warp with fewer fragments than slots
// recomputes its last one), which lets the loads run ahead of the mma's. The
// weights of one tap are staged in shared memory by cp.async,
// double-buffered, while the previous tap computes. Borders come from
// predicated loads (zeros outside the image), and h is zeroed outside the
// image before the second convolution, as zero padding of h requires. The
// epilogues run on the accumulator registers. Any H and W run; C is 32, 64
// or 128.
//
// Built with -fmad=false, so the float32 epilogue rounds like the plain
// PyTorch version (adaptivepnp_sci_torch/ops/convpair.py).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int C_, int TH_, int TW_>
struct Geo {
  static constexpr int C = C_, TH = TH_, TW = TW_;
  static constexpr int PW = TW + 4;   // pixel pitch of both tiles
  static constexpr int CP = C + 8;    // channel pitch of a pixel: aligned, conflict-free rows
  static constexpr int WP = C + 8;    // row pitch of a staged weight matrix
  static constexpr int NF = C / 16;   // 16-wide N tiles, and K steps
  static constexpr int MPW = 16 / NF; // 16-pixel M fragments per warp
  static constexpr int MCH = MPW < 4 ? MPW : 4;  // A fragments held at once
  static constexpr int MF1 = ((TH + 2) * PW + 15) / 16;  // M fragments of conv 1
  static constexpr int MF2 = (TH * PW + 15) / 16;        // M fragments of conv 2
  // pixels each tile must hold so that the last fragment's last tap stays inside
  static constexpr int XPIX = cmax((TH + 4) * PW, MF1 * 16 + 2 * PW + 2);
  static constexpr int HPIX = cmax(MF1 * 16, MF2 * 16 + 2 * PW + 2);
  static constexpr int CHUNKS = C / 8;  // 16-byte pieces of a pixel
  static constexpr size_t SMEM = size_t(XPIX + HPIX) * CP * sizeof(bf16)
                                 + 2 * size_t(C) * WP * sizeof(bf16);
  static_assert(C % 32 == 0 && NF <= 8, "C must be 32, 64 or 128");
  static_assert(MF1 <= WARPS * MPW && MF2 <= MF1, "tile too large for 8 warps");
  static_assert(SMEM <= 232448, "tile too large for shared memory");
};

struct Tile {
  int n, ty0, tx0, H, W;
};

// one tap's (C, C) weight matrix into shared memory, asynchronously
template <class G>
__device__ __forceinline__ void stage_weights(bf16* dst, const bf16* __restrict__ src) {
  for (int i = threadIdx.x; i < G::C * G::CHUNKS; i += THREADS) {
    const int row = i / G::CHUNKS, ch = i % G::CHUNKS;
    __pipeline_memcpy_async(dst + row * G::WP + ch * 8, src + row * G::C + ch * 8, 16);
  }
}

// four 8x8 b16 matrices from shared memory; lane l gives the row address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c (16x8, f32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned relu_pack(float lo, float hi, bool zeroed) {
  const __nv_bfloat162 two = __floats2bfloat162_rn(zeroed ? 0.0f : fmaxf(lo, 0.0f),
                                                   zeroed ? 0.0f : fmaxf(hi, 0.0f));
  return *reinterpret_cast<const unsigned*>(&two);
}

// Nine-tap implicit GEMM over the tile `src`, then the epilogue. FIRST: write
// bf16 h into the shared tile `hs`, zero outside the image. Otherwise: write
// bf16 out to device memory.
template <class G, int MF, bool FIRST>
__device__ __forceinline__ void conv9(const bf16* src, const bf16* __restrict__ wg, bf16* ws,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ shift, bf16* hs,
                                      bf16* __restrict__ out, const Tile t) {
  constexpr int C = G::C, PW = G::PW, CP = G::CP, WP = G::WP, NF = G::NF, MPW = G::MPW,
                MCH = G::MCH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this lane's row addresses inside a fragment: A rows are pixels, 16 of
  // them in two 8-channel halves; B rows are input channels, 16 of them for
  // two 8-wide output-channel tiles
  const int a_lane = (lane & 15) * CP + (lane >> 4) * 8;
  const int b_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * WP + (lane >> 4) * 8;

  float acc[MPW][2 * NF][4];
#pragma unroll
  for (int i = 0; i < MPW; ++i)
#pragma unroll
    for (int n8 = 0; n8 < 2 * NF; ++n8)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][n8][k] = 0.0f;

  __syncthreads();  // the weight buffers are free (and, for conv 2, hs is written)
  stage_weights<G>(ws, wg);
  __pipeline_commit();

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    __pipeline_wait_prior(0);
    __syncthreads();  // this tap's weights (and the tiles) are in place; the other buffer is free
    if (tap + 1 < 9) stage_weights<G>(ws + ((tap + 1) & 1) * C * WP, wg + (tap + 1) * C * C);
    __pipeline_commit();
    const bf16* wt = ws + (tap & 1) * C * WP + b_lane;
    const bf16* at = src + ((tap / 3) * PW + tap % 3) * CP + a_lane;
#pragma unroll
    for (int i0 = 0; i0 < MPW; i0 += MCH) {
#pragma unroll
      for (int ks = 0; ks < NF; ++ks) {
        unsigned a[MCH][4];
#pragma unroll
        for (int j = 0; j < MCH; ++j) {
          // a slot past the last fragment recomputes the last one (its result
          // is dropped in the epilogue): no branch in the inner loop
          const int mf = min(warp + WARPS * (i0 + j), MF - 1);
          ldmatrix_x4(a[j], at + mf * 16 * CP + ks * 16);
        }
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          unsigned b[4];
          ldmatrix_x4_trans(b, wt + ks * 16 * WP + nf * 16);
#pragma unroll
          for (int j = 0; j < MCH; ++j) {
            mma_16816(acc[i0 + j][2 * nf], a[j], b[0], b[1]);
            mma_16816(acc[i0 + j][2 * nf + 1], a[j], b[2], b[3]);
          }
        }
      }
    }
  }

  // epilogue on the accumulators: of each 16x8 tile a lane holds two
  // neighbouring channels of pixel lane / 4 and of the pixel 8 further on
#pragma unroll
  for (int i = 0; i < MPW; ++i) {
    const int mf = warp + WARPS * i;
    if (mf >= MF) continue;
    int q[2], r[2], c[2];
    bool inside[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      q[h] = mf * 16 + (lane >> 2) + 8 * h;
      r[h] = t.ty0 + q[h] / PW - (FIRST ? 1 : 0);
      c[h] = t.tx0 + q[h] % PW - (FIRST ? 1 : 0);
      inside[h] = r[h] >= 0 && r[h] < t.H && c[h] >= 0 && c[h] < t.W;
      if (!FIRST) inside[h] = inside[h] && q[h] / PW < G::TH && q[h] % PW < G::TW;
    }
#pragma unroll
    for (int n8 = 0; n8 < 2 * NF; ++n8) {
      const int ch = n8 * 8 + (lane & 3) * 2;
      const float2 s = __ldg(reinterpret_cast<const float2*>(scale + ch));
      const float2 b = __ldg(reinterpret_cast<const float2*>(shift + ch));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float lo = acc[i][n8][2 * h] * s.x + b.x;
        const float hi = acc[i][n8][2 * h + 1] * s.y + b.y;
        if constexpr (FIRST) {
          *reinterpret_cast<unsigned*>(hs + q[h] * CP + ch) = relu_pack(lo, hi, !inside[h]);
        } else if (inside[h]) {
          const size_t pix = (size_t(t.n) * t.H + r[h]) * t.W + c[h];
          *reinterpret_cast<unsigned*>(out + pix * C + ch) = relu_pack(lo, hi, false);
        }
      }
    }
  }
}

template <class G>
__global__ void __launch_bounds__(THREADS, 1)
convpair_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                const float* __restrict__ s1, const float* __restrict__ b1,
                const bf16* __restrict__ w2, const float* __restrict__ s2,
                const float* __restrict__ b2, bf16* __restrict__ out, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* hs = xs + G::XPIX * G::CP;
  bf16* ws = hs + G::HPIX * G::CP;
  const Tile t{int(blockIdx.z), int(blockIdx.y) * G::TH, int(blockIdx.x) * G::TW, H, W};

  // the halo tile of x: rows ty0-2 .. ty0+TH+1, columns tx0-2 .. tx0+TW+1,
  // zeros outside the image and in the tail that only unused columns read
  const bf16* xn = x + size_t(t.n) * H * W * G::C;
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < G::XPIX * G::CHUNKS; i += THREADS) {
    const int p = i / G::CHUNKS, ch = i % G::CHUNKS;
    const int tr = p / G::PW, tc = p % G::PW;
    const int r = t.ty0 - 2 + tr, c = t.tx0 - 2 + tc;
    bf16* dst = xs + p * G::CP + ch * 8;
    if (tr < G::TH + 4 && r >= 0 && r < H && c >= 0 && c < W)
      __pipeline_memcpy_async(dst, xn + (size_t(r) * W + c) * G::C + ch * 8, 16);
    else
      *reinterpret_cast<int4*>(dst) = zero;
  }
  // the part of the h tile that conv 1 does not write
  for (int i = G::MF1 * 16 * G::CHUNKS + threadIdx.x; i < G::HPIX * G::CHUNKS; i += THREADS)
    *reinterpret_cast<int4*>(hs + (i / G::CHUNKS) * G::CP + (i % G::CHUNKS) * 8) = zero;

  conv9<G, G::MF1, true>(xs, w1, ws, s1, b1, hs, nullptr, t);
  conv9<G, G::MF2, false>(hs, w2, ws, s2, b2, nullptr, out, t);
}

template <class G>
int launch(const void* x, const void* w1, const void* s1, const void* b1, const void* w2,
           const void* s2, const void* b2, void* out, int n, int h, int w, cudaStream_t stream) {
  auto kern = convpair_kernel<G>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(G::SMEM));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((w + G::TW - 1) / G::TW, (h + G::TH - 1) / G::TH, n);
  kern<<<grid, THREADS, G::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(s2), static_cast<const float*>(b2), static_cast<bf16*>(out),
      h, w);
  return int(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). All pointers are
// device pointers aligned to 16 bytes; x and out are (n, h, w, c) bf16.
extern "C" int apnp_convpair(const void* x, const void* w1, const void* s1, const void* b1,
                             const void* w2, const void* s2, const void* b2, void* out, int n,
                             int h, int w, int c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 32: return launch<Geo<32, 24, 32>>(x, w1, s1, b1, w2, s2, b2, out, n, h, w, st);
    case 64: return launch<Geo<64, 12, 32>>(x, w1, s1, b1, w2, s2, b2, out, n, h, w, st);
    case 128: return launch<Geo<128, 6, 28>>(x, w1, s1, b1, w2, s2, b2, out, n, h, w, st);
    default: return int(cudaErrorInvalidValue);
  }
}
