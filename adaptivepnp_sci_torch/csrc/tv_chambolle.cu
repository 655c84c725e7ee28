// Channel-wise 2-D Chambolle TV prox with a per-plane early stop, for Hopper
// (sm_90a).
//
// Replaces: adaptivepnp_sci_tpu/ops/pallas_kernels.py, _tv_plane_kernel
// (pallas_call in tv_chambolle_fused). Semantics of
// adaptivepnp_sci_tpu/ops/tv.py: dual fixed point with tau = 1/4, at most
// max_iter iterations; a plane stops once |E_prev - E| < eps * E_init with
// E = (sum d^2 + weight * sum |grad out|) / size, and returns out from the
// last iteration that ran.
//
// What bounds it on this card: the TPU kernel kept one whole plane and its
// dual field in fast memory. Here a 256x256 f32 plane is 256 KiB, more than
// the 227 KB of shared memory a block can have, and the kernel needs four
// such buffers (img, p_y, p_x, out). Each iteration also ends in a
// full-plane reduction that decides whether the plane goes on. So the limit
// is the rate at which one SM can stream its plane's four buffers through
// L2, and the number of SMs working: with one block per plane the flagship's
// 32 planes use 32 of the 132 SMs.
//
// What the design does about it: the simplest correct design. One block of
// 1024 threads per plane strides over the plane; p_y, p_x and out live in
// device scratch the wrapper allocates. At 512x512x8 the 32 planes' state is
// about 32 MB and stays in the 50 MB L2, so the iterations stream from L2,
// not device memory. __syncthreads() separates the divergence, gradient and
// update phases; the two energy sums are a block reduction accumulated in
// double, and thread 0 takes the stop decision for the whole block. Filling
// all 132 SMs (thread-block clusters with distributed shared memory, or
// split tiles with halos and a cross-block energy reduction) is later work.
//
// Built with -fmad=false so every elementwise step rounds like the plain
// PyTorch version (adaptivepnp_sci_torch/ops/tv.py), which also sums the
// energies in double: the two then agree on where each plane stops.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// Sums (a, b) over the block; the result is valid in thread 0.
__device__ __forceinline__ void block_sum2(double& a, double& b, double (*red)[kWarps]) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = red[0][lane];
    b = red[1][lane];
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, o);
      b += __shfl_down_sync(0xffffffffu, b, o);
    }
  }
}

// A thread's walk over one plane in steps of kThreads elements, keeping the
// (row, col) of its element without a division per step.
struct PlaneWalk {
  long long k;
  int row, col;
  const int w, d_row, d_col;
  __device__ explicit PlaneWalk(int w_)
      : k(threadIdx.x), row(static_cast<int>(threadIdx.x) / w_),
        col(static_cast<int>(threadIdx.x) % w_), w(w_), d_row(kThreads / w_),
        d_col(kThreads % w_) {}
  __device__ void next() {
    k += kThreads;
    row += d_row;
    col += d_col;
    if (col >= w) {
      col -= w;
      ++row;
    }
  }
};

__global__ void __launch_bounds__(kThreads)
tv_chambolle_kernel(const float* __restrict__ img_all, float* __restrict__ out_all,
                    float* __restrict__ py_all, float* __restrict__ px_all,
                    int* __restrict__ iters, int h, int w, float weight,
                    float tau_over_weight, float eps, int max_iter) {
  const long long size = static_cast<long long>(h) * w;
  const long long base = blockIdx.x * size;
  const float* __restrict__ img = img_all + base;
  float* __restrict__ out = out_all + base;
  float* __restrict__ py = py_all + base;
  float* __restrict__ px = px_all + base;
  const float tau = 0.25f;

  __shared__ double red[2][kWarps];
  __shared__ int stop;
  double e_init = 0.0, e_prev = 0.0;  // read by thread 0 only
  int ran = 0;

  for (int i = 0; i < max_iter; ++i) {
    // phase 1: out = img + div(p), and sum d^2 (d = 0 on the first pass,
    // when p is still zero; the scratch is not cleared, so it is not read)
    double dd = 0.0;
    for (PlaneWalk p(w); p.k < size; p.next()) {
      const long long k = p.k;
      float d = 0.f;
      if (i > 0) {
        d = -(py[k] + px[k]);
        if (p.row > 0) d += py[k - w];
        if (p.col > 0) d += px[k - 1];
      }
      out[k] = img[k] + d;
      dd += static_cast<double>(d) * static_cast<double>(d);
    }
    __syncthreads();

    // phase 2: forward differences of out, their norm, and the dual update
    double nn = 0.0;
    for (PlaneWalk p(w); p.k < size; p.next()) {
      const long long k = p.k;
      const float o = out[k];
      const float gy = p.row < h - 1 ? out[k + w] - o : 0.f;
      const float gx = p.col < w - 1 ? out[k + 1] - o : 0.f;
      const float norm = sqrtf(gy * gy + gx * gx);
      const float coef = norm * tau_over_weight + 1.f;
      const float pyk = i > 0 ? py[k] : 0.f;
      const float pxk = i > 0 ? px[k] : 0.f;
      py[k] = (pyk - tau * gy) / coef;
      px[k] = (pxk - tau * gx) / coef;
      nn += static_cast<double>(norm);
    }

    // phase 3: the plane's energy and the stop decision
    block_sum2(dd, nn, red);
    if (threadIdx.x == 0) {
      const double e = (dd + static_cast<double>(weight) * nn) / static_cast<double>(size);
      int done = 0;
      if (i == 0) {
        e_init = e;
      } else {
        done = fabs(e_prev - e) < static_cast<double>(eps) * e_init;
      }
      e_prev = e;
      stop = done;
    }
    __syncthreads();
    ran = i + 1;
    if (stop) break;
  }
  if (threadIdx.x == 0) iters[blockIdx.x] = ran;
}

}  // namespace

// n_planes blocks, one per (h, w) plane. scratch_py/px: n_planes*h*w floats
// each, contents ignored. iters: n_planes ints, the iterations each plane ran.
// Returns cudaGetLastError().
extern "C" int apnp_tv_chambolle(const float* img, float* out, float* scratch_py,
                                 float* scratch_px, int* iters, int n_planes, int h,
                                 int w, float weight, float tau_over_weight, float eps,
                                 int max_iter, void* stream) {
  tv_chambolle_kernel<<<n_planes, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, scratch_py, scratch_px, iters, h, w, weight, tau_over_weight, eps,
      max_iter);
  return static_cast<int>(cudaGetLastError());
}
