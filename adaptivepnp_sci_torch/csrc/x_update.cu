// Fused GAP / ADMM x-update over the packed Bayer cube, for Hopper (sm_90a).
//
// Replaces: adaptivepnp_sci_tpu/ops/pallas_kernels.py, _x_update_kernel
// (pallas_call in _fused_x_update), public wrappers admm_x_update and
// gap_x_update.
//
// Computes, for every pixel of the (4, H/2, W/2) output plane of every item:
//     p_t = theta_t + sign * b_t / rho          (t = 0 .. B-1)
//     r   = (y - sum_t phi_t * p_t) / (c + phi_sum)
//     x_t = p_t + lam * (phi_t * r)
// ADMM: sign -1, rho = rho, c = alpha * rho, lam = 1.
// GAP:  sign +1, rho = 1,   c = gamma,       lam = lam (any value).
//
// Items: the multi-measurement drivers solve N measurements (tiles of one
// scene, or a batch) in lockstep, with theta, b and the output (N, B, 4,
// H/2, W/2) and y (N, 4, H/2, W/2). One launch covers every item: the grid's
// y index is the item. phi and phi_sum either belong to each item (tiles) or
// are shared by all (a batch under one mask); their item stride is then 0.
// N = 1 is the single-measurement call, unchanged.
//
// What bounds it on this card: memory bandwidth. Per item it must read three
// cubes (theta, b, phi) and two planes (y, phi_sum) and write one cube:
// 35.7 MB at 512x512x8, about 11 us at 3.35 TB/s (a shared phi is read once
// for all items). It does ~6 flops per 24 bytes, far below the card's
// flop-per-byte line.
//
// What the design does about it: one thread per (plane, h, w) output pixel,
// or per 4 consecutive pixels with float4 loads when the plane size allows,
// so every warp reads 512 contiguous bytes of each array. The frame-axis sum
// stays in registers. The thread walks the B frames twice, once for the sum
// and once to write x; the second pass re-reads theta, b and phi, which the
// same thread touched a moment earlier and which it finds in L1/L2, so device
// memory still sees one read of each input and one write.
//
// Built with -fmad=false so each step rounds like the plain PyTorch version
// (adaptivepnp_sci_torch/ops/physics.py), which is what the card check holds
// it against.

#include <cuda_runtime.h>

namespace {

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p, long long i, float (&r)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p) + i);
    r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
  } else {
    r[0] = __ldg(p + i);
  }
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ p, long long i, const float (&r)[V]) {
  if constexpr (V == 4) {
    reinterpret_cast<float4*>(p)[i] = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    p[i] = r[0];
  }
}

// n_vec: number of V-wide vectors in one (4, H/2, W/2) plane. The item
// strides are in floats: phi_stride is 0 or B planes, phi_s_stride 0 or one.
template <int V>
__global__ void x_update_kernel(const float* __restrict__ theta,
                                const float* __restrict__ b,
                                const float* __restrict__ y,
                                const float* __restrict__ phi,
                                const float* __restrict__ phi_s,
                                float* __restrict__ out, int nb, long long n_vec,
                                long long phi_stride, long long phi_s_stride,
                                float sign, float rho, float c, float lam) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n_vec) return;
  const long long item = blockIdx.y;
  const long long plane = n_vec * V;
  theta += item * nb * plane;
  b += item * nb * plane;
  out += item * nb * plane;
  y += item * plane;
  phi += item * phi_stride;
  phi_s += item * phi_s_stride;

  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  for (int t = 0; t < nb; ++t) {
    const long long j = t * n_vec + i;
    float th[V], bb[V], ph[V];
    load<V>(theta, j, th);
    load<V>(b, j, bb);
    load<V>(phi, j, ph);
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] += ph[k] * (th[k] + sign * bb[k] / rho);
  }

  float yy[V], ps[V], r[V];
  load<V>(y, i, yy);
  load<V>(phi_s, i, ps);
#pragma unroll
  for (int k = 0; k < V; ++k) r[k] = (yy[k] - acc[k]) / (c + ps[k]);

  for (int t = 0; t < nb; ++t) {
    const long long j = t * n_vec + i;
    float th[V], bb[V], ph[V], o[V];
    load<V>(theta, j, th);
    load<V>(b, j, bb);
    load<V>(phi, j, ph);
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = (th[k] + sign * bb[k] / rho) + lam * (ph[k] * r[k]);
    store<V>(out, j, o);
  }
}

}  // namespace

// n_items: items (1 to 65535); plane: elements in one (4, H/2, W/2) plane;
// phi_stride, phi_s_stride: item strides of phi and phi_s in floats (0 when
// shared); vec4: 1 when plane % 4 == 0 and every pointer is 16-byte aligned.
// Returns cudaGetLastError().
extern "C" int apnp_x_update(const float* theta, const float* b, const float* y,
                             const float* phi, const float* phi_s, float* out,
                             int n_items, int nb, long long plane, long long phi_stride,
                             long long phi_s_stride, float sign, float rho, float c,
                             float lam, int vec4, void* stream) {
  constexpr int kThreads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    const long long n_vec = plane / 4;
    const dim3 grid(static_cast<unsigned>((n_vec + kThreads - 1) / kThreads), n_items);
    x_update_kernel<4><<<grid, kThreads, 0, s>>>(theta, b, y, phi, phi_s, out, nb, n_vec,
                                                 phi_stride, phi_s_stride, sign, rho, c, lam);
  } else {
    const dim3 grid(static_cast<unsigned>((plane + kThreads - 1) / kThreads), n_items);
    x_update_kernel<1><<<grid, kThreads, 0, s>>>(theta, b, y, phi, phi_s, out, nb, plane,
                                                 phi_stride, phi_s_stride, sign, rho, c, lam);
  }
  return static_cast<int>(cudaGetLastError());
}
