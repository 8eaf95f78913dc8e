// Dynamic symmetric per-tensor int8 quantization of a float32 activation,
// for Hopper (sm_90a).
//
// Replaces XLA's lowering of eadgan_tpu/ops/quant.py::_quantize_activation
// (an XLA reduction and elementwise pass, not a Pallas body) at the CelebA
// generator's three int8 layers:
//   amax = max |x|,  scale = max(amax, 1e-12) / 127,
//   q = clamp(rint(x / scale), -127, 127)   (round half to even)
// with the int8 tensor written NHWC from an NCHW or NHWC input, so the
// layout change of layer 0's cuDNN output rides this pass.
//
// Bound: memory.  The function reads x twice (the maximum must be known
// before the first element is quantized) and writes a quarter of its bytes:
// 9 bytes an element: 75.5 MB at layer 3's input, (128, 16, 16, 256) f32
// at batch 128, 22.5 us at 3.35 TB/s.  There is no arithmetic to speak of.
//
// Design: two launches on one stream.  `amax_kernel` is a grid-stride
// 16-byte load loop, a warp-shuffle and block reduction, then one atomicMax
// a block on the float's bit pattern (valid because |x| >= 0, where the
// unsigned order of the bits is the float order) into a word zeroed by a
// memset just before.  `quantize_kernel` reads that word, computes the
// scale as an IEEE division (no reciprocal, no contraction), writes the
// 0-d scale once, and quantizes 4 channels a thread: a 16-byte load from
// NHWC, or 4 loads H*W apart from NCHW, and one 4-byte store.  Division by
// __fdiv_rn and rintf give the plain version's bits exactly.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // a few waves over the 132 SMs; the loops stride over the rest

__global__ void __launch_bounds__(kThreads)
    amax_kernel(const float4* __restrict__ x, int n4, unsigned int* __restrict__ amax_bits) {
  float m = 0.0f;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n4; i += gridDim.x * kThreads) {
    const float4 v = __ldg(x + i);
    m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    atomicMax(amax_bits, __float_as_uint(m));
  }
}

__device__ __forceinline__ int quant(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));
  return static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f));
}

template <bool kNCHW>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const float* __restrict__ x, const unsigned int* __restrict__ amax_bits,
                    char4* __restrict__ q, float* __restrict__ scale_out, int c, int hw,
                    int total4) {
  const float amax = __uint_as_float(*amax_bits);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < total4; i += gridDim.x * kThreads) {
    float4 v;
    if (kNCHW) {
      // output element 4i in NHWC order: pixel pix = n * hw + p, channel ch
      const int e = i * 4;
      const int pix = e / c;
      const int ch = e - pix * c;
      const int n = pix / hw;
      const int p = pix - n * hw;
      const float* src = x + (static_cast<size_t>(n) * c + ch) * hw + p;
      v = make_float4(__ldg(src), __ldg(src + hw), __ldg(src + 2 * hw), __ldg(src + 3 * hw));
    } else {
      v = __ldg(reinterpret_cast<const float4*>(x) + i);
    }
    q[i] = make_char4(static_cast<signed char>(quant(v.x, scale)),
                      static_cast<signed char>(quant(v.y, scale)),
                      static_cast<signed char>(quant(v.z, scale)),
                      static_cast<signed char>(quant(v.w, scale)));
  }
}

int blocks_for(int n4) {
  const int b = (n4 + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks;
}

}  // namespace

// The abs-max of `n` floats (n a multiple of 4, x 16-byte aligned) into
// *amax_bits as the float's bits.
extern "C" int eadgan_int8_amax(const void* x, void* amax_bits, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(amax_bits, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n4 = n / 4;
  amax_kernel<<<blocks_for(n4), kThreads, 0, s>>>(static_cast<const float4*>(x), n4,
                                                 static_cast<unsigned int*>(amax_bits));
  return static_cast<int>(cudaGetLastError());
}

// q (B, H, W, C) int8 and the 0-d scale from x, (B, C, H, W) when `nchw`
// else (B, H, W, C), C a multiple of 4, and the abs-max bits written by
// eadgan_int8_amax.
extern "C" int eadgan_int8_quantize(const void* x, const void* amax_bits, void* q, void* scale,
                                    int b, int c, int hw, int nchw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total4 = b * c * hw / 4;
  const float* xf = static_cast<const float*>(x);
  const unsigned int* bits = static_cast<const unsigned int*>(amax_bits);
  char4* q4 = static_cast<char4*>(q);
  float* sc = static_cast<float*>(scale);
  if (nchw) {
    quantize_kernel<true><<<blocks_for(total4), kThreads, 0, s>>>(xf, bits, q4, sc, c, hw, total4);
  } else {
    quantize_kernel<false><<<blocks_for(total4), kThreads, 0, s>>>(xf, bits, q4, sc, c, hw, total4);
  }
  return static_cast<int>(cudaGetLastError());
}
