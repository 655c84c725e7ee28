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
//
// Split form, for a solve whose frame axis is spread over ranks (each rank
// holds B_local of the B frames): the frame sum needs every rank's frames
// between computing p and writing x, so the update runs as two launches
// with a collective between them:
//     partial:  p_t = theta_t + sign * b_t / rho;  term_t = phi_t * p_t
//               (the rank's frames; p is written where x will go)
//     (the terms all-gathered over the ranks: all B frames, in frame order)
//     finish:   r = (y - sum_t term_t) / (c + phi_sum);  x_t = p_t + lam * (phi_t * r)
// The sum runs over all B terms in frame order on every rank, as the fused
// kernel's does, so a rank's x is the fused kernel's bit for bit: a sum of
// per-rank partial sums would round otherwise, and the bf16 FastDVDnet path
// amplifies such a difference into tenths of a dB. Bytes per rank and item:
// partial reads three local cubes and writes two, finish reads the B-frame
// terms, p and phi and two planes and writes one local cube.

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

// Split form, pass 1. n_vec as above; nb: the rank's frames.
template <int V>
__global__ void x_update_partial_kernel(const float* __restrict__ theta,
                                        const float* __restrict__ b,
                                        const float* __restrict__ phi,
                                        float* __restrict__ p_out,
                                        float* __restrict__ terms, int nb, long long n_vec,
                                        long long phi_stride, float sign, float rho) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n_vec) return;
  const long long item = blockIdx.y;
  const long long plane = n_vec * V;
  theta += item * nb * plane;
  b += item * nb * plane;
  p_out += item * nb * plane;
  terms += item * nb * plane;
  phi += item * phi_stride;
  for (int t = 0; t < nb; ++t) {
    const long long j = t * n_vec + i;
    float th[V], bb[V], ph[V], pp[V], tt[V];
    load<V>(theta, j, th);
    load<V>(b, j, bb);
    load<V>(phi, j, ph);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      pp[k] = th[k] + sign * bb[k] / rho;
      tt[k] = ph[k] * pp[k];
    }
    store<V>(p_out, j, pp);
    store<V>(terms, j, tt);
  }
}

// Split form, pass 2: px holds p on entry and x on return (each thread reads
// its p before it writes its x). nb: the rank's frames; nb_all: all frames,
// whose terms lie at terms (item stride nb_all planes).
template <int V>
__global__ void x_update_finish_kernel(float* px, const float* __restrict__ terms,
                                       const float* __restrict__ y,
                                       const float* __restrict__ phi,
                                       const float* __restrict__ phi_s, int nb, int nb_all,
                                       long long n_vec, long long phi_stride,
                                       long long phi_s_stride, float c, float lam) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n_vec) return;
  const long long item = blockIdx.y;
  const long long plane = n_vec * V;
  px += item * nb * plane;
  terms += item * nb_all * plane;
  y += item * plane;
  phi += item * phi_stride;
  phi_s += item * phi_s_stride;

  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  for (int t = 0; t < nb_all; ++t) {
    float tt[V];
    load<V>(terms, t * n_vec + i, tt);
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] += tt[k];
  }
  float yy[V], ps[V], r[V];
  load<V>(y, i, yy);
  load<V>(phi_s, i, ps);
#pragma unroll
  for (int k = 0; k < V; ++k) r[k] = (yy[k] - acc[k]) / (c + ps[k]);

  for (int t = 0; t < nb; ++t) {
    const long long j = t * n_vec + i;
    float pp[V], ph[V], o[V];
    load<V>(phi, j, ph);
    if constexpr (V == 4) {
      const float4 v = reinterpret_cast<const float4*>(px)[j];
      pp[0] = v.x; pp[1] = v.y; pp[2] = v.z; pp[3] = v.w;
    } else {
      pp[0] = px[j];
    }
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = pp[k] + lam * (ph[k] * r[k]);
    store<V>(px, j, o);
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

// Split form, pass 1: p_out and terms (n_items, nb, plane) as theta; phi_stride
// as above; vec4 as above (p_out and terms included). Returns cudaGetLastError().
extern "C" int apnp_x_update_partial(const float* theta, const float* b, const float* phi,
                                     float* p_out, float* terms, int n_items, int nb,
                                     long long plane, long long phi_stride, float sign,
                                     float rho, int vec4, void* stream) {
  constexpr int kThreads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_vec = vec4 ? plane / 4 : plane;
  const dim3 grid(static_cast<unsigned>((n_vec + kThreads - 1) / kThreads), n_items);
  if (vec4) {
    x_update_partial_kernel<4><<<grid, kThreads, 0, s>>>(theta, b, phi, p_out, terms, nb, n_vec,
                                                         phi_stride, sign, rho);
  } else {
    x_update_partial_kernel<1><<<grid, kThreads, 0, s>>>(theta, b, phi, p_out, terms, nb, n_vec,
                                                         phi_stride, sign, rho);
  }
  return static_cast<int>(cudaGetLastError());
}

// Split form, pass 2: px (n_items, nb, plane) p in, x out; terms (n_items,
// nb_all, plane), every frame's terms in frame order; y, phi, phi_s and the
// strides as for apnp_x_update. Returns cudaGetLastError().
extern "C" int apnp_x_update_finish(float* px, const float* terms, const float* y,
                                    const float* phi, const float* phi_s, int n_items, int nb,
                                    int nb_all, long long plane, long long phi_stride,
                                    long long phi_s_stride, float c, float lam, int vec4,
                                    void* stream) {
  constexpr int kThreads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_vec = vec4 ? plane / 4 : plane;
  const dim3 grid(static_cast<unsigned>((n_vec + kThreads - 1) / kThreads), n_items);
  if (vec4) {
    x_update_finish_kernel<4><<<grid, kThreads, 0, s>>>(px, terms, y, phi, phi_s, nb, nb_all,
                                                        n_vec, phi_stride, phi_s_stride, c, lam);
  } else {
    x_update_finish_kernel<1><<<grid, kThreads, 0, s>>>(px, terms, y, phi, phi_s, nb, nb_all,
                                                        n_vec, phi_stride, phi_s_stride, c, lam);
  }
  return static_cast<int>(cudaGetLastError());
}
