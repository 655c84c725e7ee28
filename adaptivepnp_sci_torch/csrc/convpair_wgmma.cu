// Fused CvBlock conv pair (3x3 conv -> scale/shift -> ReLU, twice) in bf16 on
// Hopper's warpgroup tensor-core instruction (wgmma, sm_90a), for C = 64 and
// C = 128.
//
// Replaces: scripts/ab_pallas_convpair.py, _convpair_kernel (pallas_call in
// pallas_convpair). The function is that of csrc/convpair.cu, whose mma.sync
// kernel stays as the C = 32 path and as the earlier design to time against:
//     h   = bf16( relu( s1 * conv3x3(x, w1) + b1 ) )     zero outside the image
//     out = bf16( relu( s2 * conv3x3(h, w2) + b2 ) )
// for x (N, H, W, C) bf16, kernels (3, 3, C, C) bf16 laid out [tap][cin][cout],
// float32 s and b of C elements. Both convolutions are zero-padded by 1,
// products are summed in float32, and the scale, shift and ReLU run on the
// float32 sums. The intermediate h never leaves the SM.
//
// What bounds it on this card: operations. A pair at N = 8, C = 64, 256x256
// (or C = 128, 128x128) is 77 GFLOP against 134 MB (67 MB): 78 us at the
// 989 TFLOP/s of the bf16 tensor cores against 40 us (20 us) at 3.35 TB/s.
// Only wgmma reaches that rate: mma.sync, which the earlier design used,
// moves every A and B fragment through registers and shares the warps' instruction
// slots with the ldmatrix loads.
//
// What the design does about it:
//  * Both convolutions are implicit GEMMs of wgmma.mma_async m64nCk16
//    instructions with both operands read straight from shared memory. The
//    tiles of x and h are stored chunk-major, [C/8][pixel][8 channels], which
//    is wgmma's layout without swizzle: 8 pixels x 16 bytes are one 128-byte
//    core matrix, 8-pixel groups are 128 bytes apart and 8-channel chunks one
//    tile apart. Pixels are numbered along the tile's pitch PW = TW + 4, so a
//    tap is a constant offset of the descriptor's start address and an M
//    block is 64 consecutive pixels wherever a row ends; the columns that
//    wrap around are computed and never used. A tap's weights are staged as
//    [cin/8][cout/8][8 cin][8 cout] core matrices and read with wgmma's
//    transpose flag for B. Each warpgroup keeps the float32 accumulators of
//    its M blocks (64 pixels x C channels each) in registers over the nine
//    taps.
//  * One persistent block per SM walks over tiles. conv 1's epilogue writes h
//    over the x tile it has finished reading, so a tile costs one buffer.
//  * C = 64 (12 x 32 outputs a tile, 8 + 7 M blocks): the 18 taps of both
//    convolutions, 144 KB, are loaded once and stay in shared memory, so a
//    convolution is one uninterrupted stream of 288 (252) wgmma instructions
//    with no barrier inside, and the only traffic per tile is its halo.
//    Streaming the weights per tile instead (the first version of this
//    kernel) made the L2 cache's bandwidth the limit: 1,408 tiles x 147 KB.
//  * C = 128 (10 x 28 outputs a tile against the earlier design's 6 x 28,
//    6 + 5 M blocks): a convolution's taps are 288 KB and cannot stay, so
//    they stream through a ring of three cp.async stages, one tap ahead,
//    with one block barrier per tap while the wgmma groups of two taps
//    overlap. This shape is bound by that stream (590 KB a tile from L2).
//  * The next tile's halo is loaded while this tile's result is stored; the
//    stores are 16 bytes a lane after a transpose over each quad of lanes.
//    Borders come from cp.async's zero fill, and h is zeroed outside the
//    image by conv 1's epilogue, as zero padding of h requires. Any H and W
//    run.
//
// Built with -fmad=false, so the float32 epilogue rounds like the plain
// PyTorch version (adaptivepnp_sci_torch/ops/convpair.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// C channels; TH x TW output tile; NWG warpgroups with MB M blocks each;
// STAGES weight stages of one tap each: 18 keeps every tap of both
// convolutions resident, fewer make a ring that the taps stream through
template <int C_, int TH_, int TW_, int NWG_, int MB_, int STAGES_>
struct Geo {
  static constexpr int C = C_, TH = TH_, TW = TW_, NWG = NWG_, MB = MB_, STAGES = STAGES_;
  static constexpr bool RESIDENT = STAGES == 18;
  static constexpr int THREADS = NWG * 128;
  static constexpr int PW = TW + 4;                       // pixel pitch of both tiles
  static constexpr int CH8 = C / 8;                       // 16-byte chunks of a pixel
  static constexpr int KS = C / 16;                       // k16 steps of a tap
  static constexpr int NB1 = cdiv((TH + 2) * PW, 64);     // M blocks of conv 1
  static constexpr int NB2 = cdiv(TH * PW, 64);           // M blocks of conv 2
  // pixels a tile must hold so that the last block's last tap stays inside
  static constexpr int XNEED = cmax((TH + 4) * PW, NB1 * 64 + 2 * PW + 2);
  static constexpr int HNEED = cmax(NB1 * 64, NB2 * 64 + 2 * PW + 2);
  // the chunk stride in pixels, 1 mod 8: the 8 chunks of a pixel fall into
  // 8 different 16-byte bank groups when the halo is loaded
  static constexpr int NPIX = (cmax(XNEED, HNEED) + 6) / 8 * 8 + 1;
  static constexpr int XCHUNKS = NPIX * CH8;              // 16-byte chunks of a tile
  static constexpr int XBYTES = XCHUNKS * 16;
  static constexpr int WCHUNKS = C * CH8;                 // 16-byte chunks of a tap's weights
  static constexpr int WBYTES = WCHUNKS * 16;
  // The next halo is loaded in PARTS parts of PART chunks, each ahead of one M
  // block's output stores (measured: spread over the blocks is faster with
  // resident weights, all ahead of the first block with the ring).
  static constexpr int PARTS = RESIDENT ? MB : 1;
  static constexpr int PART = cdiv(cdiv(XCHUNKS, PARTS), THREADS) * THREADS;
  static constexpr size_t SMEM = size_t(XBYTES) + size_t(STAGES) * WBYTES;
  static_assert(C == 64 || C == 128, "C must be 64 or 128");
  static_assert(NB1 <= NWG * MB && NB2 <= NB1, "tile too large for the warpgroups");
  static_assert(STAGES >= 3 && STAGES <= 18, "a ring needs 3 stages; 18 hold every tap");
  static_assert(SMEM <= 232448, "tile too large for shared memory");
};

struct Tile {
  int n, ty0, tx0;
};


__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  // src_bytes = 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// orders this thread's writes to shared memory before wgmma's reads of them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// A wgmma matrix descriptor without swizzle: start address, leading and
// stride byte offsets, all in units of 16 bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t smem_addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  return uint64_t((smem_addr & 0x3FFFF) >> 4) | (uint64_t(lbo_bytes >> 4) << 16) |
         (uint64_t(sbo_bytes >> 4) << 32);
}

// d (64 x N, f32) = a (64 x 16, bf16, K-major in shared memory)
//                   * b (16 x N, bf16, N-major in shared memory) + (accumulate ? d : 0)
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b,
                                                 int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

// keeps the compiler from moving accumulator accesses across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ unsigned relu_pack(float lo, float hi, bool zeroed) {
  const __nv_bfloat162 two = __floats2bfloat162_rn(zeroed ? 0.0f : fmaxf(lo, 0.0f),
                                                   zeroed ? 0.0f : fmaxf(hi, 0.0f));
  return *reinterpret_cast<const unsigned*>(&two);
}

struct Args {
  const bf16* x;
  const bf16* w1;
  const float* s1;
  const float* b1;
  const bf16* w2;
  const float* s2;
  const float* b2;
  bf16* out;
  int H, W, tiles_x, tiles_y, n_tiles;
};

// The warpgroup of this thread, in a form the compiler knows to be the same
// for a whole warp: wgmma must not sit in a branch it takes for divergent.
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, int(threadIdx.x) >> 7, 0);
}

template <class G>
__device__ __forceinline__ Tile tile_of(const Args& a, int index) {
  const int per_image = a.tiles_x * a.tiles_y;
  const int n = index / per_image, rest = index % per_image;
  return Tile{n, (rest / a.tiles_x) * G::TH, (rest % a.tiles_x) * G::TW};
}

// Chunks [begin, end) of a tile's halo (rows ty0-2 .. ty0+TH+1, columns
// tx0-2 .. tx0+PW-3) into the buffer at `buf`, zeros outside the image and
// in the tail that only unused columns read.
template <class G>
__device__ __forceinline__ void load_halo(uint32_t buf, const Args& a, const Tile t, int begin,
                                          int end) {
  const bf16* xn = a.x + size_t(t.n) * a.H * a.W * G::C;
  for (int i = begin + int(threadIdx.x); i < end; i += G::THREADS) {
    const int p = i / G::CH8, ch = i % G::CH8;
    const int tr = p / G::PW, tc = p % G::PW;
    const int r = t.ty0 - 2 + tr, c = t.tx0 - 2 + tc;
    const bool ok = tr < G::TH + 4 && r >= 0 && r < a.H && c >= 0 && c < a.W;
    const bf16* src = ok ? xn + (size_t(r) * a.W + c) * G::C + ch * 8 : a.x;
    cp_async16(buf + uint32_t(ch * G::NPIX + p) * 16, src, ok ? 16 : 0);
  }
}

// One tap's (cin, cout) weights into a stage, as 8 x 8 core matrices
// [cin / 8][cout / 8][cin % 8][cout % 8]: consecutive threads write
// consecutive 16 bytes.
template <class G>
__device__ __forceinline__ void load_weights(uint32_t stage, const bf16* __restrict__ wt) {
  for (int i = int(threadIdx.x); i < G::WCHUNKS; i += G::THREADS) {
    const int kk = i & 7, n8 = (i >> 3) % G::CH8, kg = i / (8 * G::CH8);
    cp_async16(stage + uint32_t(i) * 16, wt + (kg * 8 + kk) * G::C + n8 * 8, 16);
  }
}

// One tap's wgmma instructions of this warpgroup: its M blocks times the
// k16 steps, on the tile behind `a_desc` and the weights behind `b_desc`.
template <class G, int NB>
__device__ __forceinline__ void tap_mma(float (&acc)[G::MB][G::C / 2], uint64_t a_desc,
                                        uint64_t b_desc, int tap) {
  const int wg = warpgroup_index();
  const int tap_off = (tap / 3) * G::PW + tap % 3;
#pragma unroll
  for (int i = 0; i < G::MB; ++i) {
    const int blk = i * G::NWG + wg;
    if (blk < NB) {
#pragma unroll
      for (int ks = 0; ks < G::KS; ++ks)
        Wgmma<G::C>::mma(acc[i], a_desc + uint64_t(tap_off + blk * 64 + ks * 2 * G::NPIX),
                         b_desc + uint64_t(ks * 16 * G::CH8), ks > 0 || tap > 0);
    }
  }
}

// Nine-tap implicit GEMM over the tile at `src` with the weights streaming
// through the ring, one block barrier per tap. Tap indices run on over both
// convolutions and over this block's tiles; each step prefetches the weights
// of the tap STAGES - 2 ahead, and the wgmma groups of two taps overlap.
template <class G, int NB>
__device__ __forceinline__ void conv9_ring(float (&acc)[G::MB][G::C / 2], uint32_t src,
                                           uint32_t ring, const Args& a, int tap_base,
                                           int total_taps) {
  const uint64_t a_desc = make_desc(src, G::NPIX * 16, 128);
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int g = tap_base + tap;
    // this tap's weights have landed (at a tile's first tap: its halo too)
    if (g % 18 == 0)
      cp_async_wait<0>();
    else
      cp_async_wait<G::STAGES - 3>();
    fence_proxy_async();
    wgmma_wait<1>();  // the tap two back has finished reading its stage
    __syncthreads();
    const int ahead = g + G::STAGES - 2;
    if (ahead < total_taps) {
      const bf16* w = (ahead % 18 < 9 ? a.w1 : a.w2) + size_t(ahead % 9) * G::C * G::C;
      load_weights<G>(ring + uint32_t(ahead % G::STAGES) * G::WBYTES, w);
    }
    cp_async_commit();
    wgmma_fence();
    tap_mma<G, NB>(acc, a_desc,
                   make_desc(ring + uint32_t(g % G::STAGES) * G::WBYTES, G::CH8 * 128, 128), tap);
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < G::MB; ++i) fence_regs(acc[i]);
}

// Nine-tap implicit GEMM with all nine taps' weights resident at `weights`:
// one uninterrupted stream of wgmma instructions.
template <class G, int NB>
__device__ __forceinline__ void conv9_resident(float (&acc)[G::MB][G::C / 2], uint32_t src,
                                               uint32_t weights) {
  const uint64_t a_desc = make_desc(src, G::NPIX * 16, 128);
  wgmma_fence();
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap)
    tap_mma<G, NB>(acc, a_desc,
                   make_desc(weights + uint32_t(tap) * G::WBYTES, G::CH8 * 128, 128), tap);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < G::MB; ++i) fence_regs(acc[i]);
}

// A 4 x 4 transpose of 32-bit words over the four lanes of a quad: word j of
// lane t becomes word t of lane j.
__device__ __forceinline__ void quad_transpose(unsigned (&v)[4], int t) {
  const bool odd = t & 1, high = t & 2;
  unsigned r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 1);
  unsigned r1 = __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 1);
  if (odd) {
    v[0] = r0;
    v[2] = r1;
  } else {
    v[1] = r0;
    v[3] = r1;
  }
  r0 = __shfl_xor_sync(0xffffffffu, high ? v[0] : v[2], 2);
  r1 = __shfl_xor_sync(0xffffffffu, high ? v[1] : v[3], 2);
  if (high) {
    v[0] = r0;
    v[1] = r1;
  } else {
    v[2] = r0;
    v[3] = r1;
  }
}

// The epilogue on the accumulators of M block i of this warpgroup: of each
// 8-channel group a lane holds two neighbouring channels of pixel
// 16 * warp + lane / 4 and of the pixel 8 further on. FIRST: write bf16 h
// into the tile at `hs`, zero outside the image. Otherwise: write bf16 out to
// device memory, 16 bytes a lane: the four lanes of a quad exchange their
// words so that each holds all 8 channels of one group.
template <class G, int NB, bool FIRST>
__device__ __forceinline__ void epilogue_block(const float (&acc)[G::C / 2], int i,
                                               const float* __restrict__ scale,
                                               const float* __restrict__ shift, uint32_t hs,
                                               const Args& a, const Tile t) {
  const int wg = warpgroup_index(), warp = (int(threadIdx.x) >> 5) & 3,
            lane = int(threadIdx.x) & 31, quad = lane & 3;
  const int blk = i * G::NWG + wg;
  if (blk >= NB) return;
  int q[2], r[2], c[2];
  bool inside[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    q[h] = blk * 64 + warp * 16 + (lane >> 2) + 8 * h;
    r[h] = t.ty0 + q[h] / G::PW - (FIRST ? 1 : 0);
    c[h] = t.tx0 + q[h] % G::PW - (FIRST ? 1 : 0);
    inside[h] = r[h] >= 0 && r[h] < a.H && c[h] >= 0 && c[h] < a.W;
    if (!FIRST) inside[h] = inside[h] && q[h] / G::PW < G::TH && q[h] % G::PW < G::TW;
  }
#pragma unroll
  for (int m = 0; m < G::CH8 / 4; ++m) {
    unsigned v[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n8 = 4 * m + j, ch = n8 * 8 + quad * 2;
      const float2 s = __ldg(reinterpret_cast<const float2*>(scale + ch));
      const float2 b = __ldg(reinterpret_cast<const float2*>(shift + ch));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float lo = acc[n8 * 4 + 2 * h] * s.x + b.x;
        const float hi = acc[n8 * 4 + 2 * h + 1] * s.y + b.y;
        v[h][j] = relu_pack(lo, hi, FIRST && !inside[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (FIRST) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t dst = hs + uint32_t((4 * m + j) * G::NPIX + q[h]) * 16 + quad * 4;
          asm volatile("st.shared.b32 [%0], %1;" ::"r"(dst), "r"(v[h][j]) : "memory");
        }
      } else {
        quad_transpose(v[h], quad);
        if (inside[h]) {
          const size_t pix = (size_t(t.n) * a.H + r[h]) * a.W + c[h];
          *reinterpret_cast<uint4*>(a.out + pix * G::C + (4 * m + quad) * 8) =
              make_uint4(v[h][0], v[h][1], v[h][2], v[h][3]);
        }
      }
    }
  }
}

template <class G, int NB, bool FIRST>
__device__ __forceinline__ void epilogue(const float (&acc)[G::MB][G::C / 2],
                                         const float* __restrict__ scale,
                                         const float* __restrict__ shift, uint32_t hs,
                                         const Args& a, const Tile t) {
#pragma unroll
  for (int i = 0; i < G::MB; ++i) epilogue_block<G, NB, FIRST>(acc[i], i, scale, shift, hs, a, t);
}

template <class G>
__global__ void __launch_bounds__(G::THREADS, 1) convpair_wgmma_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t tile = static_cast<uint32_t>(__cvta_generic_to_shared(smem));  // x, then h
  const uint32_t weights = tile + G::XBYTES;  // every tap, or the ring

  // this block's tiles: blockIdx.x, blockIdx.x + gridDim.x, ...
  const int my_tiles = (a.n_tiles - int(blockIdx.x) + int(gridDim.x) - 1) / int(gridDim.x);
  const int total_taps = my_tiles * 18;

  // The first tile's halo and the first weights, as cp.async groups in the
  // order in which they are waited for. Resident: conv 1's weights go with
  // the halo, conv 2's follow and land while conv 1 computes. Ring: the halo,
  // then a group for each of the first STAGES - 2 taps.
  load_halo<G>(tile, a, tile_of<G>(a, blockIdx.x), 0, G::XCHUNKS);
  if constexpr (G::RESIDENT) {
    for (int tap = 0; tap < 9; ++tap)
      load_weights<G>(weights + uint32_t(tap) * G::WBYTES, a.w1 + size_t(tap) * G::C * G::C);
    cp_async_commit();
    for (int tap = 0; tap < 9; ++tap)
      load_weights<G>(weights + uint32_t(9 + tap) * G::WBYTES,
                      a.w2 + size_t(tap) * G::C * G::C);
    cp_async_commit();
  } else {
    cp_async_commit();
    for (int g = 0; g < G::STAGES - 2; ++g) {
      load_weights<G>(weights + uint32_t(g) * G::WBYTES, a.w1 + size_t(g) * G::C * G::C);
      cp_async_commit();
    }
  }

  float acc[G::MB][G::C / 2];
#pragma unroll 1
  for (int it = 0; it < my_tiles; ++it) {
    const Tile t = tile_of<G>(a, int(blockIdx.x) + it * int(gridDim.x));
    if constexpr (G::RESIDENT) {
      if (it == 0)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();  // the halo (and conv 1's weights) have landed
      conv9_resident<G, G::NB1>(acc, tile, weights);
    } else {
      conv9_ring<G, G::NB1>(acc, tile, weights, a, it * 18, total_taps);
    }
    __syncthreads();  // every warpgroup has finished reading x: h goes over it
    epilogue<G, G::NB1, true>(acc, a.s1, a.b1, tile, a, t);
    if constexpr (G::RESIDENT) {
      if (it == 0) cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();  // h is written (and conv 2's weights have landed)
      conv9_resident<G, G::NB2>(acc, tile, weights + 9 * G::WBYTES);
    } else {
      conv9_ring<G, G::NB2>(acc, tile, weights, a, it * 18 + 9, total_taps);
    }
    __syncthreads();  // every warpgroup has finished reading h
    // the next halo is loaded while this tile's result is stored
    const Tile next = tile_of<G>(a, int(blockIdx.x) + (it + 1) * int(gridDim.x));
#pragma unroll
    for (int i = 0; i < G::MB; ++i) {
      if (i < G::PARTS && it + 1 < my_tiles)
        load_halo<G>(tile, a, next, i * G::PART, min((i + 1) * G::PART, G::XCHUNKS));
      epilogue_block<G, G::NB2, false>(acc[i], i, a.s2, a.b2, 0u, a, t);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
}

template <class G>
int launch(Args a, int n, cudaStream_t stream) {
  auto kern = convpair_wgmma_kernel<G>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(G::SMEM));
  if (err != cudaSuccess) return int(err);
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return int(err);
  a.tiles_x = (a.W + G::TW - 1) / G::TW;
  a.tiles_y = (a.H + G::TH - 1) / G::TH;
  a.n_tiles = n * a.tiles_x * a.tiles_y;
  const int grid = a.n_tiles < sms ? a.n_tiles : sms;
  kern<<<grid, G::THREADS, G::SMEM, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). All pointers are
// device pointers aligned to 16 bytes; x and out are (n, h, w, c) bf16 with
// c = 64 or 128.
extern "C" int apnp_convpair_wgmma(const void* x, const void* w1, const void* s1,
                                   const void* b1, const void* w2, const void* s2,
                                   const void* b2, void* out, int n, int h, int w, int c,
                                   void* stream) {
  const Args a{static_cast<const bf16*>(x),   static_cast<const bf16*>(w1),
               static_cast<const float*>(s1), static_cast<const float*>(b1),
               static_cast<const bf16*>(w2),  static_cast<const float*>(s2),
               static_cast<const float*>(b2), static_cast<bf16*>(out),
               h, w, 0, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 64: return launch<Geo<64, 12, 32, 2, 4, 18>>(a, n, st);
    case 128: return launch<Geo<128, 10, 28, 3, 2, 3>>(a, n, st);
    default: return int(cudaErrorInvalidValue);
  }
}
