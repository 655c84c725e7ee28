// Folded BatchNorm, ReLU and bf16 rounding after a bf16 convolution, in one
// pass, for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. On the TPU, XLA fused this epilogue into the
// convolution before it; in the port the convolution is the library's, and
// its epilogue ran as five PyTorch passes (upcast, scale, shift, ReLU, round:
// adaptivepnp_sci_torch/ops/convpair.py, scale_shift_relu). This kernel does
// those five in one.
//
// Computes, for x (N, C, H, W) bf16 and float32 s, b of C elements:
//     y = bf16( relu( float(x) * s[c] + b[c] ) )
// with x either channels-last in memory (the channel of flat element i is
// i mod C) or NCHW-contiguous (it is (i / HW) mod C); y has the layout of x.
// The product and the sum are rounded separately (__fmul_rn, __fadd_rn: no
// contraction into an FMA, which would round once where PyTorch rounds
// twice), the ReLU passes NaN through as torch.relu does, and the result is
// rounded to nearest even: y equals the plain version bit for bit.
//
// What bounds it on this card: bytes. It reads 2 and writes 2 bytes an
// element and does 3 flops on them: 4 B an element at 3.35 TB/s, 0.225 ms at
// FastDVDnet's largest site (90 channels at 512 x 512, N = 8: 188.7 M
// elements) and 0.89 ms for the ten sites of a prior call (746 M elements).
// The five PyTorch passes move ~36 B an element.
//
// What the design does about it: one pass over device memory. Each thread
// loads and stores 16 bytes (8 bf16) at a time, neighbouring threads on
// neighbouring vectors, in a grid-stride loop of as many blocks as the card
// holds at once; s and b are staged in shared memory, interleaved, so that an
// element's pair is one 8-byte load. A vector's 8 elements may straddle
// channels (C = 90 is not a multiple of 8), so the thread walks its channel
// element by element: it knows the channel and the offset within the
// channel's run (1 element channels-last, HW elements NCHW) of its vector's
// first element, steps them per element, and advances them by the loop's
// stride without a division. The last total mod 8 elements are done one a
// thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kVec = 8;

// The position of a flat element: channel c, offset r within the run of
// `inner` consecutive elements that share that channel.
struct Pos {
  int c;
  long long r;
};

__device__ __forceinline__ Pos pos_of(long long i, long long inner, int C) {
  const long long q = i / inner;
  return {int(q % C), i - q * inner};
}

__device__ __forceinline__ void step(Pos& p, long long inner, int C) {
  if (++p.r == inner) {
    p.r = 0;
    if (++p.c == C) p.c = 0;
  }
}

__device__ __forceinline__ bf16 epilogue(bf16 x, float2 sb) {
  const float t = __fadd_rn(__fmul_rn(__bfloat162float(x), sb.x), sb.y);
  return __float2bfloat16_rn(isnan(t) ? t : fmaxf(t, 0.0f));
}

// n_vec = total / 8 vectors; the loop's stride, stride * 8 elements, is
// step_c channels and step_r elements of a run (step_r < inner, step_c < C).
__global__ void __launch_bounds__(kThreads)
bn_relu_kernel(const bf16* __restrict__ x, const float* __restrict__ s,
               const float* __restrict__ b, bf16* __restrict__ y, long long total,
               long long n_vec, int C, long long inner, int step_c, long long step_r) {
  extern __shared__ float2 sb[];  // (s[c], b[c])
  for (int k = threadIdx.x; k < C; k += blockDim.x) sb[k] = make_float2(s[k], b[k]);
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  Pos start = pos_of(v * kVec, inner, C);
  for (; v < n_vec; v += stride) {
    uint4 raw = __ldg(reinterpret_cast<const uint4*>(x) + v);
    bf16* e = reinterpret_cast<bf16*>(&raw);
    Pos p = start;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      e[k] = epilogue(e[k], sb[p.c]);
      step(p, inner, C);
    }
    reinterpret_cast<uint4*>(y)[v] = raw;
    start.r += step_r;
    if (start.r >= inner) {
      start.r -= inner;
      ++start.c;
    }
    start.c += step_c;
    if (start.c >= C) start.c -= C;
  }

  const long long tail = n_vec * kVec + threadIdx.x;
  if (blockIdx.x == 0 && tail < total) {
    const Pos p = pos_of(tail, inner, C);
    y[tail] = epilogue(x[tail], sb[p.c]);
  }
}

}  // namespace

// x, y: total = N * C * H * W bf16 elements, 16-byte aligned, in one layout;
// inner: 1 when channels-last, H * W when NCHW-contiguous; s, b: C float32.
// Returns cudaGetLastError().
extern "C" int apnp_bn_relu(const void* x, const void* s, const void* b, void* y,
                            long long total, int C, long long inner, void* stream) {
  if (total < 1 || C < 1 || inner < 1) return int(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = size_t(C) * sizeof(float2);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bn_relu_kernel, kThreads, smem);
  if (err != cudaSuccess) return int(err);
  const long long n_vec = total / kVec;
  const long long needed = (n_vec + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const long long grid = needed < 1 ? 1 : (needed < resident || resident < 1 ? needed : resident);
  const long long stride_elems = grid * kThreads * kVec;
  const long long step_q = stride_elems / inner;
  bn_relu_kernel<<<unsigned(grid), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(s), static_cast<const float*>(b),
      static_cast<bf16*>(y), total, n_vec, C, inner, int(step_q % C),
      stride_elems - step_q * inner);
  return int(cudaGetLastError());
}
