// The spectral norm of a weight, forward and backward, for Hopper (sm_90a):
// flax's SpectralNorm as the port's SNConv and SNDense take it
// (models/layers.py::_SpectralNorm), one power step from the stored u and
// the weight divided by the resulting sigma, written in the layer's compute
// type.
//
// It replaces no Pallas kernel: the JAX package leaves flax's SpectralNorm to
// XLA, which fuses it into the step's program.  In the port it replaces the
// ~22 torch kernels of a forward (three matrix-vector products, the norms,
// the division of the whole weight by a 0-d tensor, the cast to bf16) and
// the ~13 of a backward (the division's gradient, its reduction for sigma's
// gradient, the outer product, the cast back).
//
// W is the float32 weight as (rows, cols) = (out, K), row-major.  Forward:
//   x = u W,  v = x rsqrt(|x|^2 + eps),  Wv = W v,
//   u' = Wv rsqrt(|Wv|^2 + eps),  sigma = Wv . u',
//   s = sigma if sigma != 0 else 1,  Wn = (W / s) in float32 or bf16,
// with the division an IEEE float32 division rounded once to the output
// type, so Wn holds the bits of torch's (W / s).to(dtype) for this sigma;
// u' and sigma go to the layer's buffers only when the call updates them.
// Backward, from G = dL/dWn:
//   dW = G / s + (c u') v^T,  c = -(sum(G * W) / s) / s  (0 where sigma is 0),
// as autograd through torch's expression (the division's gradient plus
// sigma's, through sigma = (W v) . u' with u and v held constant).
//
// Bound: memory.  A forward must read W once and write Wn (6 bytes an
// element in bf16), a backward read G and W and write dW (10 bytes); the
// power step needs all of W before sigma exists, so the forward reads W
// three times and the backward G twice, each later read starting where the
// one before ended, in what L2 still holds.
//
// Design.  A weight of at most ops/sn_cuda.py's ONE_BLOCK_MAX elements
// takes one block of 1,024 threads each way: one launch a forward, one a
// backward.  A larger one takes three launches forward: the column sums x
// (a block a 32-column tile, a warp a row stride, the warps' sums added in
// order), the row products Wv (a block two rows, every thread over the
// columns, the last rows first; each block works out |x| itself and block 0
// writes v), and the division (each block works out u' and sigma from Wv
// itself, block 0 writes them); two backward: one partial sum of G * W a
// block, then each block adds the partials itself and writes its share of
// dW, from the end.  The second and third launches of each are programmatic
// dependent launches, whose start overlaps the tail of the one before.
// Every sum is taken in a fixed order (butterflies in a warp and over a
// block's warps, then blocks in order), with no atomics: two runs, or a run
// and a replayed CUDA graph of it, give the same bits.  The kernels allocate
// nothing: the wrapper hands in the outputs and the scratch.  Rows take
// 16-byte loads where cols is a multiple of 4 and the pointers are aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kEps = 1e-12f;           // ops/sn_cuda.py: SN_EPS
constexpr int kBlock = 1024;             // threads of the one-block kernels and the column sums
constexpr int kThreads = 256;            // threads of the large path's other kernels
constexpr int kRowsPerBlock = 2;         // rows a block of the row products takes
constexpr int kMaxBlocks = 1024;         // blocks of an elementwise pass (ops/sn_cuda.py: MAX_PARTIALS)
constexpr int kElementsPerBlock = 2048;  // elements a block of an elementwise pass, before the cap

__device__ __forceinline__ float warp_sum(float x) {
  for (int offset = 16; offset > 0; offset >>= 1) x += __shfl_xor_sync(0xffffffffu, x, offset);
  return x;
}

// The sum over the block of every thread's x, the same bits in every thread:
// each warp's butterfly, then a butterfly over the warps' sums, which every
// warp takes alike.  `red` holds a float a warp.
__device__ __forceinline__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  __syncthreads();  // the previous call's readers of red are done
  if (lane == 0) red[warp] = x;
  __syncthreads();
  return warp_sum(lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned int*>(&lo);
  raw.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// From Wv (`rows` floats): u' = Wv rsqrt(|Wv|^2 + eps) and sigma = Wv . u',
// by the whole block in a fixed order.  A block that `writes` stores u' and
// sigma, and also into the layer's u and sigma when `update`.  wv and u_new
// may be one array: each thread reads and writes only its own rows.
__device__ __forceinline__ float power_step_end(const float* wv, float* u_new, float* sig, float* u,
                                                float* sigma_buf, int rows, bool writes, bool update,
                                                float* red) {
  float squares = 0.f;
  for (int o = threadIdx.x; o < rows; o += blockDim.x) squares = fmaf(wv[o], wv[o], squares);
  const float r2 = rsqrtf(block_sum(squares, red) + kEps);
  float dot = 0.f;
  for (int o = threadIdx.x; o < rows; o += blockDim.x) {
    const float a = wv[o];
    const float uo = a * r2;
    dot = fmaf(a, uo, dot);
    if (writes) {
      u_new[o] = uo;
      if (update) u[o] = uo;
    }
  }
  const float sigma = block_sum(dot, red);
  if (writes && threadIdx.x == 0) {
    *sig = sigma;
    if (update) *sigma_buf = sigma;
  }
  return sigma;
}

// The flat passes take the elements [lo, hi) (multiples of 4 where `vec`,
// then in fours), this thread those at first, first + stride, ...

// out = w / s.
template <typename T>
__device__ __forceinline__ void divide(const float* __restrict__ w, T* __restrict__ out, float s,
                                       long long lo, long long hi, long long first, long long stride,
                                       bool vec) {
  if (vec) {
#pragma unroll 4
    for (long long j = lo / 4 + first; j < hi / 4; j += stride) {
      const float4 a = load4(w + 4 * j);
      store4(out + 4 * j, make_float4(__fdiv_rn(a.x, s), __fdiv_rn(a.y, s), __fdiv_rn(a.z, s),
                                      __fdiv_rn(a.w, s)));
    }
  } else {
    for (long long e = lo + first; e < hi; e += stride) store(out + e, __fdiv_rn(__ldg(w + e), s));
  }
}

// This thread's share of sum(g * w).
template <typename T>
__device__ __forceinline__ float grad_dot(const T* __restrict__ g, const float* __restrict__ w,
                                          long long lo, long long hi, long long first, long long stride,
                                          bool vec) {
  float acc = 0.f;
  if (vec) {
#pragma unroll 4
    for (long long j = lo / 4 + first; j < hi / 4; j += stride) {
      const float4 a = load4(g + 4 * j), b = load4(w + 4 * j);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
  } else {
    for (long long e = lo + first; e < hi; e += stride) acc = fmaf(to_float(g[e]), __ldg(w + e), acc);
  }
  return acc;
}

// dW = G / s + (c u'[o]) v[k], rounded at each operation as autograd's
// kernels round; from hi down when `reverse` (G's last elements, which
// the pass before read last).
__device__ __forceinline__ float grad_element(float g, float s, float cu, float vk) {
  return __fadd_rn(__fdiv_rn(g, s), __fmul_rn(cu, vk));
}

template <typename T>
__device__ __forceinline__ void write_grad(const T* __restrict__ g, const float* u_new, const float* v,
                                           float sigma, float sum_gw, float* __restrict__ dw, int cols,
                                           long long lo, long long hi, long long first, long long stride,
                                           bool vec, bool reverse) {
  const bool nonzero = sigma != 0.f;
  const float s = nonzero ? sigma : 1.f;
  const float c = nonzero ? -__fdiv_rn(__fdiv_rn(sum_gw, s), s) : 0.f;
  if (vec) {
#pragma unroll 4
    for (long long i = first; i < (hi - lo) / 4; i += stride) {
      const long long e = lo + 4 * (reverse ? (hi - lo) / 4 - 1 - i : i);
      const int o = static_cast<int>(e / cols);
      const int k = static_cast<int>(e - static_cast<long long>(o) * cols);
      const float cu = __fmul_rn(c, u_new[o]);
      const float4 a = load4(g + e);
      store4(dw + e, make_float4(grad_element(a.x, s, cu, v[k]), grad_element(a.y, s, cu, v[k + 1]),
                                 grad_element(a.z, s, cu, v[k + 2]), grad_element(a.w, s, cu, v[k + 3])));
    }
  } else {
    for (long long i = first; i < hi - lo; i += stride) {
      const long long e = lo + (reverse ? hi - lo - 1 - i : i);
      const int o = static_cast<int>(e / cols);
      const int k = static_cast<int>(e - static_cast<long long>(o) * cols);
      dw[e] = grad_element(to_float(g[e]), s, __fmul_rn(c, u_new[o]), v[k]);
    }
  }
}

// --- one block -------------------------------------------------------------

// x = u W by the block, W columns at a time (4 where `vec`): with at most
// kBlock units of W columns, thread t takes unit t % units over the rows
// t / units, + groups, ... (every load of a thread independent of the
// others; at most 32 groups), and the groups' sums are added in group order
// through `part` (kBlock * 4 floats); with more, each thread takes whole
// columns.
template <int W>
__device__ __forceinline__ void one_block_column_sums(const float* w, const float* u, float* x, int rows,
                                                      int cols, float* part) {
  const int units = cols / W;
  const int t = threadIdx.x;
  if (units <= kBlock) {
    const int groups = min(kBlock / units, 32);
    if (t < groups * units) {
      const int c = t % units, g = t / units;
      float acc[W] = {};
#pragma unroll 8
      for (int o = g; o < rows; o += groups) {
        const float uo = u[o];
        const float* p = w + static_cast<long long>(o) * cols + c * W;
        if constexpr (W == 4) {
          const float4 a = load4(p);
          acc[0] = fmaf(uo, a.x, acc[0]);
          acc[1] = fmaf(uo, a.y, acc[1]);
          acc[2] = fmaf(uo, a.z, acc[2]);
          acc[3] = fmaf(uo, a.w, acc[3]);
        } else {
          acc[0] = fmaf(uo, __ldg(p), acc[0]);
        }
      }
#pragma unroll
      for (int i = 0; i < W; ++i) part[g * cols + c * W + i] = acc[i];
    }
    __syncthreads();
    for (int k = t; k < cols; k += kBlock) {
      float total = 0.f;
      for (int g = 0; g < groups; ++g) total += part[g * cols + k];
      x[k] = total;
    }
  } else {
    for (int c = t; c < units; c += kBlock) {
      float acc[W] = {};
#pragma unroll 8
      for (int o = 0; o < rows; ++o) {
        const float uo = u[o];
#pragma unroll
        for (int i = 0; i < W; ++i) acc[i] = fmaf(uo, __ldg(w + static_cast<long long>(o) * cols + c * W + i), acc[i]);
      }
#pragma unroll
      for (int i = 0; i < W; ++i) x[c * W + i] = acc[i];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
    sn_forward_one_block(const float* __restrict__ w, float* u, float* sigma_buf, T* __restrict__ out,
                         float* v, float* u_new, float* sig, int rows, int cols, int update, int vec) {
  __shared__ float part[kBlock * 4];
  __shared__ float red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (vec) {
    one_block_column_sums<4>(w, u, v, rows, cols, part);
  } else {
    one_block_column_sums<1>(w, u, v, rows, cols, part);
  }
  __syncthreads();
  // each thread normalizes the columns of x it reads
  float squares = 0.f;
  for (int k = threadIdx.x; k < cols; k += kBlock) squares = fmaf(v[k], v[k], squares);
  const float r1 = rsqrtf(block_sum(squares, red) + kEps);
  for (int k = threadIdx.x; k < cols; k += kBlock) v[k] *= r1;
  __syncthreads();
  // Wv into u_new, a warp a row
  for (int o = warp; o < rows; o += 32) {
    const float* row = w + static_cast<long long>(o) * cols;
    float acc = 0.f;
    if (vec) {
      for (int q = lane; q < cols / 4; q += 32) {
        const float4 a = load4(row + 4 * q);
        const float4 b = *reinterpret_cast<const float4*>(v + 4 * q);
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
        acc = fmaf(a.z, b.z, acc);
        acc = fmaf(a.w, b.w, acc);
      }
    } else {
      for (int k = lane; k < cols; k += 32) acc = fmaf(__ldg(row + k), v[k], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) u_new[o] = acc;
  }
  __syncthreads();
  const float sigma = power_step_end(u_new, u_new, sig, u, sigma_buf, rows, true, update, red);
  divide(w, out, sigma != 0.f ? sigma : 1.f, 0, static_cast<long long>(rows) * cols, threadIdx.x,
         kBlock, vec);
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
    sn_backward_one_block(const T* __restrict__ g, const float* __restrict__ w, const float* u_new,
                          const float* v, const float* sig, float* __restrict__ dw, int rows, int cols,
                          int vec) {
  __shared__ float red[32];
  const long long n = static_cast<long long>(rows) * cols;
  const float sum_gw = block_sum(grad_dot(g, w, 0, n, threadIdx.x, kBlock, vec), red);
  write_grad(g, u_new, v, *sig, sum_gw, dw, cols, 0, n, threadIdx.x, kBlock, vec, false);
}

// --- the large path ----------------------------------------------------------

// Waits for the kernel before on the stream (its writes visible) where it
// launched this one early (programmatic dependent launch); a no-op otherwise.
__device__ __forceinline__ void wait_for_previous_kernel() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// x[k] = sum_o u[o] w[o, k] over a block's 32 columns: lane l takes column
// 32 blockIdx + l, warp j rows j, j + 32, ...; the 32 warps' sums are added
// in warp order.
__global__ void __launch_bounds__(kBlock)
    sn_column_sums(const float* __restrict__ w, const float* __restrict__ u, float* __restrict__ x,
                   int rows, int cols) {
  __shared__ float part[32][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (k < cols) {
#pragma unroll 8
    for (int o = warp; o < rows; o += 32) {
      acc = fmaf(__ldg(u + o), __ldg(w + static_cast<long long>(o) * cols + k), acc);
    }
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && k < cols) {
    float total = 0.f;
    for (int j = 0; j < 32; ++j) total += part[j][lane];
    x[k] = total;
  }
}

// Wv for a block's kRowsPerBlock rows, the last rows first (the column sums
// read them last): the rows' products with x and |x|^2 in one pass, then
// Wv = (W x) / |x|; block 0 also writes v = x / |x|.
__global__ void __launch_bounds__(kThreads)
    sn_row_products(const float* __restrict__ w, const float* __restrict__ x, float* __restrict__ v,
                    float* __restrict__ wv, int rows, int cols, int vec) {
  __shared__ float red[kThreads / 32];
  __shared__ float row_part[kThreads / 32][kRowsPerBlock];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first_row = (gridDim.x - 1 - blockIdx.x) * kRowsPerBlock;
  const int n_rows = min(kRowsPerBlock, rows - first_row);
  const float* base = w + static_cast<long long>(first_row) * cols;
  wait_for_previous_kernel();
  float squares = 0.f;
  float acc[kRowsPerBlock] = {};
  if (vec) {
#pragma unroll 4
    for (int j = threadIdx.x; j < cols / 4; j += kThreads) {
      const float4 xj = *reinterpret_cast<const float4*>(x + 4 * j);
      squares = fmaf(xj.x, xj.x, squares);
      squares = fmaf(xj.y, xj.y, squares);
      squares = fmaf(xj.z, xj.z, squares);
      squares = fmaf(xj.w, xj.w, squares);
#pragma unroll
      for (int r = 0; r < kRowsPerBlock; ++r) {
        if (r < n_rows) {
          const float4 a = load4(base + static_cast<long long>(r) * cols + 4 * j);
          acc[r] = fmaf(a.x, xj.x, acc[r]);
          acc[r] = fmaf(a.y, xj.y, acc[r]);
          acc[r] = fmaf(a.z, xj.z, acc[r]);
          acc[r] = fmaf(a.w, xj.w, acc[r]);
        }
      }
    }
  } else {
    for (int k = threadIdx.x; k < cols; k += kThreads) {
      const float xk = x[k];
      squares = fmaf(xk, xk, squares);
#pragma unroll
      for (int r = 0; r < kRowsPerBlock; ++r) {
        if (r < n_rows) acc[r] = fmaf(__ldg(base + static_cast<long long>(r) * cols + k), xk, acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerBlock; ++r) {
    const float total = warp_sum(acc[r]);
    if (lane == 0) row_part[warp][r] = total;
  }
  const float r1 = rsqrtf(block_sum(squares, red) + kEps);  // its barriers publish row_part
  if (threadIdx.x < n_rows) {
    float total = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) total += row_part[i][threadIdx.x];
    wv[first_row + threadIdx.x] = total * r1;
  }
  if (blockIdx.x == 0) {
    for (int k = threadIdx.x; k < cols; k += kThreads) v[k] = x[k] * r1;
  }
}

// u' and sigma, worked out by every block from all of Wv (block 0 writes
// them), then W / s over the grid, from the start (the row products read
// the first rows last).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sn_divide(const float* __restrict__ w, const float* __restrict__ wv, T* __restrict__ out,
              float* u_new, float* sig, float* u, float* sigma_buf, int rows, long long n, int update,
              int vec) {
  __shared__ float red[kThreads / 32];
  wait_for_previous_kernel();
  const float sigma =
      power_step_end(wv, u_new, sig, u, sigma_buf, rows, blockIdx.x == 0, update, red);
  divide(w, out, sigma != 0.f ? sigma : 1.f, 0, n,
         static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x,
         static_cast<long long>(gridDim.x) * kThreads, vec);
}

// A block's partial sum of G * W over the grid's share of the elements.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sn_grad_partials(const T* __restrict__ g, const float* __restrict__ w, float* __restrict__ partials,
                     long long n, int vec) {
  __shared__ float red[kThreads / 32];
  const float total = block_sum(
      grad_dot(g, w, 0, n, static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x,
               static_cast<long long>(gridDim.x) * kThreads, vec),
      red);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// Each block adds the partials in block order, then dW over the grid, from
// the end (G's last elements, which the partial sums read last).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sn_grad(const T* __restrict__ g, const float* __restrict__ partials, int n_partials,
            const float* u_new, const float* v, const float* sig, float* __restrict__ dw, int cols,
            long long n, int vec) {
  __shared__ float red[kThreads / 32];
  wait_for_previous_kernel();
  float part = 0.f;
  for (int i = threadIdx.x; i < n_partials; i += kThreads) part += partials[i];
  const float sum_gw = block_sum(part, red);
  write_grad(g, u_new, v, *sig, sum_gw, dw, cols, 0, n,
             static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x,
             static_cast<long long>(gridDim.x) * kThreads, vec, true);
}

int elementwise_blocks(long long n) {
  const long long blocks = (n + kElementsPerBlock - 1) / kElementsPerBlock;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

bool aligned(const void* p, int bytes) { return (reinterpret_cast<uintptr_t>(p) % bytes) == 0; }

// Launches `kernel` on `stream` allowed to start before the kernel before it
// ends (programmatic dependent launch): it waits for that kernel's writes in
// wait_for_previous_kernel, and its launch overlaps the other's tail.
template <typename... Params, typename... Args>
int launch_after(void (*kernel)(Params...), int blocks, int threads, cudaStream_t stream,
                 Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(threads);
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&config, kernel, static_cast<Params>(args)...));
}

template <typename T>
int forward(const float* w, float* u, float* sigma_buf, T* out, float* v, float* u_new, float* sig,
            float* x, float* wv, int rows, int cols, int update, int one_block, cudaStream_t stream) {
  const long long n = static_cast<long long>(rows) * cols;
  const int vec = cols % 4 == 0 && aligned(w, 16) && aligned(out, 4 * sizeof(T)) && aligned(x, 16) &&
                  aligned(v, 16);
  if (one_block) {
    sn_forward_one_block<T><<<1, kBlock, 0, stream>>>(w, u, sigma_buf, out, v, u_new, sig, rows, cols,
                                                     update, vec);
    return static_cast<int>(cudaGetLastError());
  }
  sn_column_sums<<<(cols + 31) / 32, kBlock, 0, stream>>>(w, u, x, rows, cols);
  int err = static_cast<int>(cudaGetLastError());
  if (err == 0) {
    err = launch_after(sn_row_products, (rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, stream,
                       w, x, v, wv, rows, cols, vec);
  }
  if (err == 0) {
    err = launch_after(sn_divide<T>, elementwise_blocks(n), kThreads, stream, w, wv, out, u_new, sig, u,
                       sigma_buf, rows, n, update, vec);
  }
  return err;
}

template <typename T>
int backward(const T* g, const float* w, const float* u_new, const float* v, const float* sig,
             float* partials, float* dw, int rows, int cols, int one_block, cudaStream_t stream) {
  const long long n = static_cast<long long>(rows) * cols;
  const int vec = cols % 4 == 0 && aligned(g, 4 * sizeof(T)) && aligned(w, 16) && aligned(dw, 16);
  if (one_block) {
    sn_backward_one_block<T><<<1, kBlock, 0, stream>>>(g, w, u_new, v, sig, dw, rows, cols, vec);
    return static_cast<int>(cudaGetLastError());
  }
  const int blocks = elementwise_blocks(n);
  sn_grad_partials<T><<<blocks, kThreads, 0, stream>>>(g, w, partials, n, vec);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_after(sn_grad<T>, blocks, kThreads, stream, g, partials, blocks, u_new, v, sig, dw,
                      cols, n, vec);
}

}  // namespace

// One forward of the spectral norm of the float32 weight `w` (rows x cols),
// from the layer's `u` (rows): the normalized weight into `out` (float32, or
// bf16 when out_bf16), v (cols), u' (rows) and sigma (1) into `v`, `u_new`
// and `sig` for the backward, and, when `update`, u' and sigma into the
// layer's `u` and `sigma_buf`; `x` (cols) and `wv` (rows) are the large
// path's scratch, 16-byte aligned like `v`.  One launch when `one_block`,
// else three, on `stream`.
extern "C" int eadgan_sn_forward(const void* w, void* u, void* sigma_buf, void* out, int out_bf16,
                                 void* v, void* u_new, void* sig, void* x, void* wv, int rows, int cols,
                                 int update, int one_block, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* wf = static_cast<const float*>(w);
  const auto f = [](void* p) { return static_cast<float*>(p); };
  if (out_bf16) {
    return forward(wf, f(u), f(sigma_buf), static_cast<__nv_bfloat16*>(out), f(v), f(u_new), f(sig),
                   f(x), f(wv), rows, cols, update, one_block, s);
  }
  return forward(wf, f(u), f(sigma_buf), static_cast<float*>(out), f(v), f(u_new), f(sig), f(x), f(wv),
                 rows, cols, update, one_block, s);
}

// One backward: dW (float32, rows x cols) from the gradient `grad` of the
// normalized weight (bf16 when grad_bf16, else float32), the weight and the
// forward's u', v and sigma; `partials` holds MAX_PARTIALS floats of
// scratch.  One launch when `one_block`, else two, on `stream`.
extern "C" int eadgan_sn_backward(const void* grad, int grad_bf16, const void* w, const void* u_new,
                                  const void* v, const void* sig, void* partials, void* dw, int rows,
                                  int cols, int one_block, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (grad_bf16) {
    return backward(static_cast<const __nv_bfloat16*>(grad), f(w), f(u_new), f(v), f(sig),
                    static_cast<float*>(partials), static_cast<float*>(dw), rows, cols, one_block, s);
  }
  return backward(static_cast<const float*>(grad), f(w), f(u_new), f(v), f(sig),
                  static_cast<float*>(partials), static_cast<float*>(dw), rows, cols, one_block, s);
}
