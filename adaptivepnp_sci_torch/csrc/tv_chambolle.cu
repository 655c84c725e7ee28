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
// What bounds it on this card: bytes. One read of the planes and one write of
// the result is all device memory has to see (16.8 MB for the flagship's 32
// planes of 256x256, 5.0 us at 3.35 TB/s); the five iterations in between
// are a stencil over the plane's state (out, p_y, p_x) with a full-plane
// reduction at the end of each, which decides whether the plane goes on. The
// TPU kernel kept one whole plane and its dual field in fast memory. Here a
// 256x256 f32 plane is 256 KiB, more than the 227 KB of shared memory a block
// can have, and a block per plane would use 32 of the 132 SMs.
//
// What the design does about it: a thread-block cluster per plane
// (tv_chambolle_cluster_kernel). The plane is cut into strips of rows, one
// per block of the cluster (7 blocks of 37 rows at 256x256: 224 blocks of 512
// threads, two to an SM, all 32 clusters of the flagship's planes resident
// at once; 8 blocks would pack into the card's GPCs only 30 at a time). A block keeps out, p_y and p_x of its strip in
// shared memory for the whole call, so device memory sees the input once and
// the output once; the input is read again from L2 in each iteration. The
// two halo rows (p_y of the row above the strip for the divergence, out of
// the row below it for the gradient) are read from the neighbour block's
// shared memory (distributed shared memory); cluster.sync() separates the
// phases. Each block reduces its strip's two energy sums in double and
// writes the pair into every block's shared memory; after the barrier every
// thread adds the pairs in rank order and takes the same stop decision, so
// the result does not change from run to run (no atomics). What is left is
// arithmetic latency: a pixel costs an IEEE square root and two IEEE
// divisions per iteration, which the plain version's bits require.
//
// Planes whose strips do not fit in shared memory at the largest portable
// cluster (8 blocks) take tv_chambolle_grid_kernel when the whole card's
// shared memory holds a plane's strips (up to about 1500x1500): a software
// cluster that spans the card. One cooperative launch puts every block on
// the card at once, in groups of as many blocks as a plane has strips (128
// strips of 8 rows at 1024x1024, two blocks an SM: 2 groups, 2 planes in
// flight); a group takes its planes one after another, each block keeping
// its strip's state in shared memory while the group is on a plane. The halo
// rows and the strips' sums pass through a small buffer in device memory
// that L2 holds, and the group's blocks meet at a counter in device memory
// (twice an iteration, as cluster.sync() is used above); groups never wait
// on one another.
//
// Larger planes take tv_chambolle_kernel, the first design: one block of
// 1024 threads per plane strides over the plane, with p_y, p_x and out in
// device scratch the wrapper allocates (they stream through L2), block
// barriers between the phases and thread 0 taking the decision. The wrapper
// chooses by the plane's shape before the launch
// (adaptivepnp_sci_torch/ops/cuda_kernels.py, tv_plan).
//
// Built with -fmad=false so every elementwise step rounds like the plain
// PyTorch version (adaptivepnp_sci_torch/ops/tv.py), which also sums the
// energies in double: the two then agree on where each plane stops.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// Sums (a, b) over a block of WARPS warps; the result is valid in thread 0.
template <int WARPS>
__device__ __forceinline__ void block_sum2(double& a, double& b, double (*red)[WARPS]) {
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
    a = lane < WARPS ? red[0][lane] : 0.0;
    b = lane < WARPS ? red[1][lane] : 0.0;
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
    block_sum2<kWarps>(dd, nn, red);
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

constexpr int kClusterThreads = 512;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kBatch = 4;  // pixels of a thread in flight at once in phase 1

// Two blocks of the cluster kernel share an SM when their strips allow it
// (at most 64 registers a thread, strips of at most ~113 KB).
__global__ void __launch_bounds__(kClusterThreads, 2)
tv_chambolle_cluster_kernel(const float* __restrict__ img_all, float* __restrict__ out_all,
                            int* __restrict__ iters, int h, int w, int strip_h, float weight,
                            float tau_over_weight, float eps, int max_iter) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());  // this block's strip
  const int plane = blockIdx.x / ranks;
  const long long size = static_cast<long long>(h) * w;
  const float tau = 0.25f;

  // rows r0 .. r1-1 of the plane; the last strips may be short or empty
  const int r0 = min(rank * strip_h, h), r1 = min(r0 + strip_h, h);
  const int rows = r1 - r0, npix = rows * w;
  const int tid = static_cast<int>(threadIdx.x);

  // the three buffers do not overlap: __restrict__ lets the loads of one
  // pixel move ahead of the stores of another
  extern __shared__ float strip[];
  float* __restrict__ out_s = strip;
  float* __restrict__ py_s = strip + strip_h * w;
  float* __restrict__ px_s = strip + 2 * strip_h * w;
  __shared__ double red[2][kClusterWarps];
  __shared__ double part[8][2];  // every strip's (sum d^2, sum |grad out|), by rank

  // the halo rows live in the neighbours' shared memory: the last row of p_y
  // of the strip above (always a full strip), the first row of out of the
  // strip below
  const float* py_up = rank > 0 ? cluster.map_shared_rank(py_s, rank - 1) + (strip_h - 1) * w
                                : nullptr;
  const float* out_down = rank + 1 < ranks ? cluster.map_shared_rank(out_s, rank + 1) : nullptr;

  const long long base = plane * size + static_cast<long long>(r0) * w;
  const float* __restrict__ img = img_all + base;
  const int row_0 = tid / w, col_0 = tid % w;
  const int d_row = kClusterThreads / w, d_col = kClusterThreads % w;
  // a thread's next pixel is kClusterThreads further on in its strip
  auto advance = [&](int& row, int& col) {
    row += d_row;
    col += d_col;
    if (col >= w) {
      col -= w;
      ++row;
    }
  };
  double e_init = 0.0, e_prev = 0.0;  // every thread keeps the same copy
  int ran = 0;

  // Phase 1 takes a thread's pixels kBatch at a time, all loads of a batch
  // ahead of its stores, so that kBatch reads of img from L2 are in flight.
  // (Batching phase 2 the same way gained nothing and cost registers: at 64
  // a thread any spill goes through an L1 that shared memory has emptied.)
  for (int i = 0; i < max_iter; ++i) {
    // phase 1: out = img + div(p), and sum d^2 (d = 0 on the first pass,
    // when p is still zero; the shared memory is not cleared, so it is not
    // read). img comes from device memory once and from L2 after that.
    double dd = 0.0;
    {
      int row = row_0, col = col_0;
      for (int k0 = tid; k0 < npix; k0 += kBatch * kClusterThreads) {
        float im[kBatch], p[kBatch], up[kBatch], left[kBatch];
        bool has_up[kBatch], has_left[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int k = k0 + u * kClusterThreads;
          has_up[u] = has_left[u] = false;
          if (k < npix) {
            im[u] = __ldg(img + k);
            if (i > 0) {
              p[u] = py_s[k] + px_s[k];
              has_up[u] = r0 + row > 0;
              has_left[u] = col > 0;
              if (has_up[u]) up[u] = row > 0 ? py_s[k - w] : py_up[col];
              if (has_left[u]) left[u] = px_s[k - 1];
            }
          }
          advance(row, col);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int k = k0 + u * kClusterThreads;
          if (k < npix) {
            float d = 0.f;
            if (i > 0) {
              d = -p[u];
              if (has_up[u]) d += up[u];
              if (has_left[u]) d += left[u];
            }
            out_s[k] = im[u] + d;
            dd += static_cast<double>(d) * static_cast<double>(d);
          }
        }
      }
    }
    cluster.sync();  // out is written in every strip

    // phase 2: forward differences of out, their norm, and the dual update
    double nn = 0.0;
    {
      int row = row_0, col = col_0;
      for (int k = tid; k < npix; k += kClusterThreads) {
        const float o = out_s[k];
        float gy = 0.f;
        if (r0 + row < h - 1) gy = (row < rows - 1 ? out_s[k + w] : out_down[col]) - o;
        const float gx = col < w - 1 ? out_s[k + 1] - o : 0.f;
        const float norm = sqrtf(gy * gy + gx * gx);
        const float coef = norm * tau_over_weight + 1.f;
        const float pyk = i > 0 ? py_s[k] : 0.f;
        const float pxk = i > 0 ? px_s[k] : 0.f;
        py_s[k] = (pyk - tau * gy) / coef;
        px_s[k] = (pxk - tau * gx) / coef;
        nn += static_cast<double>(norm);
        advance(row, col);
      }
    }

    // phase 3: the strip's sums go to every block of the cluster; after the
    // barrier each thread adds them in rank order and decides for the plane
    block_sum2<kClusterWarps>(dd, nn, red);
    if (tid == 0) {
      for (int r = 0; r < ranks; ++r) {
        double* dst = cluster.map_shared_rank(&part[0][0], r);
        dst[2 * rank] = dd;
        dst[2 * rank + 1] = nn;
      }
    }
    cluster.sync();  // p is written in every strip, and the sums have arrived
    double sum_dd = 0.0, sum_nn = 0.0;
    for (int r = 0; r < ranks; ++r) {
      sum_dd += part[r][0];
      sum_nn += part[r][1];
    }
    const double e = (sum_dd + static_cast<double>(weight) * sum_nn) / static_cast<double>(size);
    bool done = false;
    if (i == 0) {
      e_init = e;
    } else {
      done = fabs(e_prev - e) < static_cast<double>(eps) * e_init;
    }
    e_prev = e;
    ran = i + 1;
    if (done) break;
  }

  // no block reads another's shared memory after the last barrier
  float* __restrict__ out = out_all + base;
  for (int k = tid; k < npix; k += kClusterThreads) out[k] = out_s[k];
  if (rank == 0 && tid == 0) iters[plane] = ran;
}

// Barrier of the `blocks` blocks of one group of the grid kernel: each
// arrives at the group's counter in device memory after a fence that
// publishes what its threads wrote, and waits until all have arrived.
// `target` counts the group's arrivals so far (the counter is zeroed before
// the launch); every thread keeps the same copy. A wait far longer than any
// phase (2^26 polls, tens of seconds) means a block of the group is not running:
// the kernel traps, and the launch fails, rather than hang the card.
__device__ __forceinline__ void group_sync(unsigned int* counter, unsigned int& target,
                                           unsigned int blocks) {
  __syncthreads();
  target += blocks;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    unsigned int seen, polls = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(counter) : "memory");
      if (++polls == (1u << 26)) __trap();
    } while (static_cast<int>(seen - target) < 0);
  }
  __syncthreads();
}

// The grid design: gridDim.x / strips groups of `strips` blocks, all resident
// at once (a cooperative launch). Block r of group g holds strip r, rows
// r*strip_h .. of planes g, g + groups, g + 2*groups, ..., one after another;
// its strip's out, p_y and p_x stay in shared memory while the group is on a
// plane. The halo rows pass through device memory (L2): halo_py[b] is the
// last row of p_y of strip b, halo_out[b] the first row of out of strip b+1,
// for the strips-1 boundaries b of each group; each strip's two sums go to
// sums[g*strips + r]. Stores to them bypass L1 (__stcg) and so do the loads
// (__ldcg): L1 is not coherent across SMs. Same phases and arithmetic as the
// cluster kernel.
__global__ void __launch_bounds__(kClusterThreads, 2)
tv_chambolle_grid_kernel(const float* __restrict__ img_all, float* __restrict__ out_all,
                         int* __restrict__ iters, float* __restrict__ halo_py,
                         float* __restrict__ halo_out, double2* __restrict__ sums,
                         unsigned int* __restrict__ counters, int n_planes, int h, int w,
                         int strips, int strip_h, float weight, float tau_over_weight, float eps,
                         int max_iter) {
  const int groups = static_cast<int>(gridDim.x) / strips;
  const int group = static_cast<int>(blockIdx.x) / strips;
  const int rank = static_cast<int>(blockIdx.x) % strips;  // this block's strip
  const long long size = static_cast<long long>(h) * w;
  const float tau = 0.25f;

  // rows r0 .. r1-1 of every plane; only the last strip may be short
  const int r0 = rank * strip_h, r1 = min(r0 + strip_h, h);
  const int rows = r1 - r0, npix = rows * w;
  const int tid = static_cast<int>(threadIdx.x);

  extern __shared__ float strip[];
  float* __restrict__ out_s = strip;
  float* __restrict__ py_s = strip + strip_h * w;
  float* __restrict__ px_s = strip + 2 * strip_h * w;
  __shared__ double red[2][kClusterWarps];
  __shared__ int stop;

  // this group's halo rows: read p_y above and out below, publish out's first
  // row (for the strip above) and p_y's last row (for the strip below)
  const long long halo_base = static_cast<long long>(group) * (strips - 1) * w;
  const float* py_up = rank > 0 ? halo_py + halo_base + static_cast<long long>(rank - 1) * w
                                : nullptr;
  float* out_pub = rank > 0 ? halo_out + halo_base + static_cast<long long>(rank - 1) * w
                            : nullptr;
  float* py_pub = rank + 1 < strips ? halo_py + halo_base + static_cast<long long>(rank) * w
                                    : nullptr;
  const float* out_down = rank + 1 < strips
                              ? halo_out + halo_base + static_cast<long long>(rank) * w
                              : nullptr;
  double2* group_sums = sums + static_cast<long long>(group) * strips;
  unsigned int* counter = counters + 32 * group;  // one 128-byte line a group
  unsigned int target = 0;

  const int row_0 = tid / w, col_0 = tid % w;
  const int d_row = kClusterThreads / w, d_col = kClusterThreads % w;
  auto advance = [&](int& row, int& col) {
    row += d_row;
    col += d_col;
    if (col >= w) {
      col -= w;
      ++row;
    }
  };

  for (int plane = group; plane < n_planes; plane += groups) {
    const long long base = plane * size + static_cast<long long>(r0) * w;
    const float* __restrict__ img = img_all + base;
    double e_init = 0.0, e_prev = 0.0;  // read by thread 0 only
    int ran = 0;

    for (int i = 0; i < max_iter; ++i) {
      // phase 1: out = img + div(p), and sum d^2; img comes from device
      // memory once and from L2 after that
      double dd = 0.0;
      {
        int row = row_0, col = col_0;
        for (int k0 = tid; k0 < npix; k0 += kBatch * kClusterThreads) {
          float im[kBatch], p[kBatch], up[kBatch], left[kBatch];
          bool has_up[kBatch], has_left[kBatch], first_row[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int k = k0 + u * kClusterThreads;
            has_up[u] = has_left[u] = false;
            first_row[u] = row == 0;
            if (k < npix) {
              im[u] = __ldg(img + k);
              if (i > 0) {
                p[u] = py_s[k] + px_s[k];
                has_up[u] = r0 + row > 0;
                has_left[u] = col > 0;
                if (has_up[u]) up[u] = row > 0 ? py_s[k - w] : __ldcg(py_up + col);
                if (has_left[u]) left[u] = px_s[k - 1];
              }
            }
            advance(row, col);
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int k = k0 + u * kClusterThreads;
            if (k < npix) {
              float d = 0.f;
              if (i > 0) {
                d = -p[u];
                if (has_up[u]) d += up[u];
                if (has_left[u]) d += left[u];
              }
              const float o = im[u] + d;
              out_s[k] = o;
              if (first_row[u] && out_pub) __stcg(out_pub + k, o);
              dd += static_cast<double>(d) * static_cast<double>(d);
            }
          }
        }
      }
      group_sync(counter, target, strips);  // out is written in every strip

      // phase 2: forward differences of out, their norm, and the dual update
      double nn = 0.0;
      {
        int row = row_0, col = col_0;
        for (int k = tid; k < npix; k += kClusterThreads) {
          const float o = out_s[k];
          float gy = 0.f;
          if (r0 + row < h - 1) gy = (row < rows - 1 ? out_s[k + w] : __ldcg(out_down + col)) - o;
          const float gx = col < w - 1 ? out_s[k + 1] - o : 0.f;
          const float norm = sqrtf(gy * gy + gx * gx);
          const float coef = norm * tau_over_weight + 1.f;
          const float pyk = i > 0 ? py_s[k] : 0.f;
          const float pxk = i > 0 ? px_s[k] : 0.f;
          const float py_new = (pyk - tau * gy) / coef;
          py_s[k] = py_new;
          px_s[k] = (pxk - tau * gx) / coef;
          if (row == rows - 1 && py_pub) __stcg(py_pub + col, py_new);
          nn += static_cast<double>(norm);
          advance(row, col);
        }
      }

      // phase 3: the strip's sums go to its slot; after the barrier warp 0 of
      // every block adds the group's slots in one fixed order (a strided sum
      // a lane, then a butterfly, whose lanes all end with the same bits) and
      // decides for the plane
      block_sum2<kClusterWarps>(dd, nn, red);
      if (tid == 0) __stcg(group_sums + rank, make_double2(dd, nn));
      group_sync(counter, target, strips);  // p is written, the sums have arrived
      if (tid < 32) {
        double sum_dd = 0.0, sum_nn = 0.0;
        for (int r = tid; r < strips; r += 32) {
          const double2 s = __ldcg(group_sums + r);
          sum_dd += s.x;
          sum_nn += s.y;
        }
        for (int o = 16; o > 0; o >>= 1) {
          sum_dd += __shfl_xor_sync(0xffffffffu, sum_dd, o);
          sum_nn += __shfl_xor_sync(0xffffffffu, sum_nn, o);
        }
        if (tid == 0) {
          const double e =
              (sum_dd + static_cast<double>(weight) * sum_nn) / static_cast<double>(size);
          int done = 0;
          if (i == 0) {
            e_init = e;
          } else {
            done = fabs(e_prev - e) < static_cast<double>(eps) * e_init;
          }
          e_prev = e;
          stop = done;
        }
      }
      __syncthreads();
      ran = i + 1;
      if (stop) break;
    }

    float* __restrict__ out = out_all + base;
    for (int k = tid; k < npix; k += kClusterThreads) out[k] = out_s[k];
    if (rank == 0 && tid == 0) iters[plane] = ran;
  }
}

size_t strip_bytes(int strip_h, int w) { return 3 * size_t(strip_h) * w * sizeof(float); }

cudaLaunchConfig_t cluster_config(int n_planes, int cluster, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_planes * cluster);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The first design: n_planes blocks, one per (h, w) plane, any plane size.
// scratch_py/px: n_planes*h*w floats each, contents ignored. iters: n_planes
// ints, the iterations each plane ran. Returns cudaGetLastError().
extern "C" int apnp_tv_chambolle(const float* img, float* out, float* scratch_py,
                                 float* scratch_px, int* iters, int n_planes, int h,
                                 int w, float weight, float tau_over_weight, float eps,
                                 int max_iter, void* stream) {
  tv_chambolle_kernel<<<n_planes, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, scratch_py, scratch_px, iters, h, w, weight, tau_over_weight, eps,
      max_iter);
  return static_cast<int>(cudaGetLastError());
}

// The cluster design: n_planes clusters of `cluster` blocks (1, 2, 4 or 8),
// block r of a cluster holding rows r*strip_h .. of its plane in
// 3*strip_h*w*4 bytes of shared memory; cluster*strip_h >= h and
// 3*strip_h*w*4 bytes within the block's shared memory. Returns the cudaError_t of the launch.
extern "C" int apnp_tv_chambolle_cluster(const float* img, float* out, int* iters,
                                         int n_planes, int h, int w, int cluster,
                                         int strip_h, float weight, float tau_over_weight,
                                         float eps, int max_iter, void* stream) {
  const size_t smem = strip_bytes(strip_h, w);
  cudaError_t err = cudaFuncSetAttribute(tv_chambolle_cluster_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(n_planes, cluster, smem, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, tv_chambolle_cluster_kernel, img, out, iters, h, w, strip_h,
                           weight, tau_over_weight, eps, max_iter);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of that shape the device runs at once, and how many of
// their blocks share an SM; returns a cudaError_t. With n_planes clusters
// launched, min(n_planes, clusters) * cluster / blocks_per_sm SMs are busy.
extern "C" int apnp_tv_cluster_occupancy(int cluster, int strip_h, int w, int* clusters,
                                         int* blocks_per_sm) {
  const size_t smem = strip_bytes(strip_h, w);
  cudaError_t err = cudaFuncSetAttribute(tv_chambolle_cluster_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, cluster, smem, nullptr, &attr);
  err = cudaOccupancyMaxActiveClusters(clusters, tv_chambolle_cluster_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, tv_chambolle_cluster_kernel, kClusterThreads, smem));
}

// The grid design: `groups` groups of `strips` blocks in one cooperative
// launch, block r of a group holding rows r*strip_h .. of its planes in
// 3*strip_h*w*4 bytes of shared memory; strips*strip_h >= h > (strips-1)*strip_h.
// Device workspace the caller allocates: counters, groups*32 unsigned ints
// (zeroed here, on the stream, before the launch); sums, groups*strips
// double2; halo, 2*groups*(strips-1)*w floats (p_y rows, then out rows).
// Every block has to be resident at once: groups*strips at most
// apnp_tv_grid_occupancy's blocks per SM times the SMs, or the launch fails.
// Returns the cudaError_t of the memset or the launch.
extern "C" int apnp_tv_chambolle_grid(const float* img, float* out, int* iters,
                                      unsigned int* counters, double* sums, float* halo,
                                      int n_planes, int h, int w, int strips, int strip_h,
                                      int groups, float weight, float tau_over_weight, float eps,
                                      int max_iter, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = strip_bytes(strip_h, w);
  cudaError_t err = cudaFuncSetAttribute(tv_chambolle_grid_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(counters, 0, size_t(groups) * 32 * sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * strips);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  float* halo_out = halo + size_t(groups) * (strips - 1) * w;
  err = cudaLaunchKernelEx(&cfg, tv_chambolle_grid_kernel, img, out, iters, halo, halo_out,
                           reinterpret_cast<double2*>(sums), counters, n_planes, h, w, strips,
                           strip_h, weight, tau_over_weight, eps, max_iter);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many blocks of the grid kernel with strips of strip_h x w share an SM;
// returns a cudaError_t.
extern "C" int apnp_tv_grid_occupancy(int strip_h, int w, int* blocks_per_sm) {
  const size_t smem = strip_bytes(strip_h, w);
  cudaError_t err = cudaFuncSetAttribute(tv_chambolle_grid_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, tv_chambolle_grid_kernel, kClusterThreads, smem));
}
