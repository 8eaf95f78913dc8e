// One Adam step over every tensor of an optimizer, in one launch, for
// Hopper (sm_90a): the train step's optimizers (train/state.py::FusedAdam).
//
// Replaces torch's foreach capturable Adam (torch.optim.Adam with
// capturable=True), which the port's train steps ran before.  It
// replaces no Pallas kernel: the JAX package leaves Adam to XLA, which
// fuses optax's update into the step's program.  Same function as
// torch's Adam without weight decay, in float32: for each parameter p
// with gradient g, moments m and v and step count s (a float32 0-d
// tensor on the card), t = s + 1 and
//   m <- b1 m + (1 - b1) g,   v <- b2 v + (1 - b2) g^2,
//   p <- p - lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps),
// then s <- t.  The bias corrections are computed in double from s on
// the card and rounded to float once, as the CPU's Adam rounds its host
// scalars; ops/adam_cuda.py::adam_plain repeats this arithmetic.
//
// Bound: memory.  Each element is read from p, g, m and v once and
// written to p, m and v once, 28 bytes, against ~12 flops: CelebA's
// three optimizers (51.84 M elements a step) move 1.452 GB, 0.433 ms at
// 3.35 TB/s.  torch's foreach path makes about seven passes over the
// moments and parameters instead, and divides by per-parameter 0-d
// tensors one broadcasting kernel per tensor.
//
// Design: the launch's arguments hold every tensor's pointers and size
// by value (AdamLaunch, under 4 KB), so a CUDA graph that captures the
// launch holds them, and the gradients' fixed addresses inside the
// graph's pool, with no table in device memory.  Each tensor is cut into
// chunks of kChunk elements and each block updates one chunk, with
// 16-byte loads and stores where all four of its pointers are 16-byte
// aligned (chunks start at multiples of kChunk, so the tensor's base
// decides) and one element a thread in the ragged tail; one block a
// chunk gives CelebA's largest optimizer ~6,300 blocks, many waves of
// 132 SMs.  The parameter block is read through __grid_constant__, so
// indexing its tables at run time reads it in place.  Thread 0 of a
// block finds its tensor, reads its step count and computes the two
// bias corrections once for the block.  The step counts advance on the
// card inside the same launch: every block adds one to a counter in
// device memory after its thread 0 has read its count, and the block
// that brings the counter to the grid's size, the last, so after every
// read, writes each tensor's s + 1 and sets the counter back to 0 for
// the next launch.  Nothing is read back to the host, so a replayed
// graph advances the counts and the corrections with it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxTensors = 64;  // tensors a launch (ops/adam_cuda.py: MAX_TENSORS)
constexpr int kChunk = 4096;     // elements a block (ops/adam_cuda.py: CHUNK)
constexpr int kThreads = 256;

struct AdamTensor {
  float* param;
  const float* grad;
  float* exp_avg;
  float* exp_avg_sq;
  float* step;
  long long numel;
};

struct AdamLaunch {
  AdamTensor tensors[kMaxTensors];
  int first_chunk[kMaxTensors + 1];  // tensor i's chunks: [first_chunk[i], first_chunk[i + 1])
  int count;
  unsigned int* done;  // blocks finished; 0 between launches
  double lr, beta1, beta2;
  float eps;
};

static_assert(sizeof(AdamLaunch) <= 4096, "a kernel's parameters are limited to 4 KB");

struct Coefficients {
  float b1, one_minus_b1, b2, one_minus_b2, step_size, bc2_sqrt, eps;
};

__device__ __forceinline__ void adam_element(float& p, float g, float& m, float& v,
                                             const Coefficients& c) {
  m = c.b1 * m + c.one_minus_b1 * g;
  v = c.b2 * v + c.one_minus_b2 * g * g;
  p = p - c.step_size * m / (sqrtf(v) / c.bc2_sqrt + c.eps);
}

__global__ void __launch_bounds__(kThreads) adam_fused_kernel(const __grid_constant__ AdamLaunch a) {
  __shared__ AdamTensor tensor;
  __shared__ long long start;
  __shared__ float step_size, bc2_sqrt;
  __shared__ int has_work;
  __shared__ int last;

  const int chunk = blockIdx.x;
  if (threadIdx.x == 0) {
    has_work = chunk < a.first_chunk[a.count];
    if (has_work) {
      int i = 0;
      while (a.first_chunk[i + 1] <= chunk) ++i;  // skips tensors of no chunk
      tensor = a.tensors[i];
      start = static_cast<long long>(chunk - a.first_chunk[i]) * kChunk;
      const double t = static_cast<double>(*a.tensors[i].step) + 1.0;
      step_size = static_cast<float>(a.lr / (1.0 - pow(a.beta1, t)));
      bc2_sqrt = static_cast<float>(sqrt(1.0 - pow(a.beta2, t)));
    }
  }
  __syncthreads();

  if (has_work) {
    const Coefficients c{static_cast<float>(a.beta1), static_cast<float>(1.0 - a.beta1),
                         static_cast<float>(a.beta2), static_cast<float>(1.0 - a.beta2),
                         step_size, bc2_sqrt, a.eps};
    const long long left = tensor.numel - start;
    const int len = left < kChunk ? static_cast<int>(left) : kChunk;
    float* p = tensor.param + start;
    const float* g = tensor.grad + start;
    float* m = tensor.exp_avg + start;
    float* v = tensor.exp_avg_sq + start;
    const bool aligned = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                           reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
    int vector_end = 0;
    if (aligned) {
      const int n4 = len / 4;
      float4* p4 = reinterpret_cast<float4*>(p);
      const float4* g4 = reinterpret_cast<const float4*>(g);
      float4* m4 = reinterpret_cast<float4*>(m);
      float4* v4 = reinterpret_cast<float4*>(v);
#pragma unroll 4
      for (int j = threadIdx.x; j < n4; j += kThreads) {
        float4 pj = p4[j], mj = m4[j], vj = v4[j];
        const float4 gj = __ldg(g4 + j);
        adam_element(pj.x, gj.x, mj.x, vj.x, c);
        adam_element(pj.y, gj.y, mj.y, vj.y, c);
        adam_element(pj.z, gj.z, mj.z, vj.z, c);
        adam_element(pj.w, gj.w, mj.w, vj.w, c);
        p4[j] = pj;
        m4[j] = mj;
        v4[j] = vj;
      }
      vector_end = n4 * 4;
    }
    for (int j = vector_end + threadIdx.x; j < len; j += kThreads) {
      adam_element(p[j], __ldg(g + j), m[j], v[j], c);
    }
  }

  // thread 0 read this block's step count before it gets here
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    for (int i = threadIdx.x; i < a.count; i += kThreads) *a.tensors[i].step += 1.0f;
    if (threadIdx.x == 0) *a.done = 0;
  }
}

}  // namespace

extern "C" int eadgan_adam_launch_bytes() { return static_cast<int>(sizeof(AdamLaunch)); }

// One Adam step over the tensors `args` (an AdamLaunch on the host) lists,
// on `stream`; the launch copies the arguments, so the host's copy may go
// once this returns.
extern "C" int eadgan_adam_fused(const void* args, void* stream) {
  const AdamLaunch* a = static_cast<const AdamLaunch*>(args);
  const int chunks = a->first_chunk[a->count];
  adam_fused_kernel<<<chunks > 0 ? chunks : 1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
