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
// Bound: memory.  Read x once and write a quarter of its bytes: 5 bytes an
// element, 42.0 MB at layer 3's input, (128, 16, 16, 256) f32 at batch
// 128, 12.5 us at 3.35 TB/s.  There is no arithmetic to speak of.
//
// Design.  The abs-max of layers 2 and 3's inputs comes from the
// int8_convt kernel that wrote them (its epilogue's atomicMax), so their
// quantization is one launch that reads x once.  Only layer 1's input, a
// cuDNN output, takes `amax_kernel` first: a grid-stride 16-byte load
// loop, a warp-shuffle and block reduction, then one atomicMax a block on
// the float's bit pattern (valid because |x| >= 0, where the unsigned
// order of the bits is the float order) into a word zeroed by a memset
// just before.  The quantize kernels read that word, compute the scale as
// an IEEE division (no reciprocal, no contraction) and write the 0-d scale
// once.  From NHWC, consecutive threads take consecutive groups of 4
// elements, a 16-byte load and a 4-byte store each, four groups a thread
// with their loads in flight together.  From NCHW, a block loads a slab of
// up to 4,096 floats, whole channels of up to 64 pixels of one image (256
// channels of 4 x 4 at layer 1), with consecutive threads on consecutive
// addresses, transposes it in shared memory, and a thread quantizes 16
// channels of one pixel (4 where C is no multiple of 16) and writes them
// in one store.  __fdiv_rn and rintf give the plain version's bits exactly.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // a few waves over the 132 SMs; the loops stride over the rest
constexpr int kSlab = 4096;          // NCHW: floats a block transposes, at most
constexpr int kSlabP = 64;           // NCHW: pixels a block, at most

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

__device__ __forceinline__ float scale_of(const unsigned int* amax_bits) {
  return __fdiv_rn(fmaxf(__uint_as_float(*amax_bits), 1e-12f), 127.0f);
}

// the int8 bits of clamp(rint(v / scale), -127, 127)
__device__ __forceinline__ uint32_t quant(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));
  return static_cast<uint32_t>(static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f))) & 0xFFu;
}

// four int8 values, the first in the lowest byte
__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d, float scale) {
  return quant(a, scale) | (quant(b, scale) << 8) | (quant(c, scale) << 16) |
         (quant(d, scale) << 24);
}

__device__ __forceinline__ uint32_t pack4(float4 v, float scale) {
  return pack4(v.x, v.y, v.z, v.w, scale);
}

// NHWC: a thread quantizes kUnroll float4 groups a grid stride apart, all
// their loads in flight before the first store; consecutive threads on
// consecutive groups, so a warp reads 512 and writes 128 contiguous bytes
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
    quantize_nhwc_kernel(const float4* __restrict__ x, const unsigned int* __restrict__ amax_bits,
                         uint32_t* __restrict__ q, float* __restrict__ scale_out, int n4) {
  const float scale = scale_of(amax_bits);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n4; i += kUnroll * stride) {
    float4 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (i + k * stride < n4) v[k] = __ldg(x + i + k * stride);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (i + k * stride < n4) q[i + k * stride] = pack4(v[k], scale);
  }
}

// NCHW: a block transposes a slab of slab_c channels x slab_p pixels of
// one image (slab_c * slab_p <= kSlab) through shared memory, rows
// slab_p + 1 floats apart so that the transposed reads spread over the
// banks.  kVec channels a store: 16 when C % 16 == 0, else 4.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
    quantize_nchw_kernel(const float* __restrict__ x, const unsigned int* __restrict__ amax_bits,
                         int8_t* __restrict__ q, float* __restrict__ scale_out, int c, int hw,
                         int slab_c, int slab_p) {
  extern __shared__ float slab[];
  const float scale = scale_of(amax_bits);
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && threadIdx.x == 0) *scale_out = scale;
  const int p0 = blockIdx.x * slab_p;
  const int c0 = blockIdx.y * slab_c;
  const int n = blockIdx.z;
  const int nc = min(slab_c, c - c0);
  const int np = min(slab_p, hw - p0);
  const int row = slab_p + 1;
  // consecutive threads on consecutive pixels of a channel, then the next
  // channel: where the slab holds whole channels it is one contiguous run,
  // read in 16-byte pieces when a piece stays within a channel
  const float* src = x + (static_cast<size_t>(n) * c + c0) * hw + p0;
  if (np == hw && hw % 4 == 0) {
    for (int i = threadIdx.x; i < nc * np / 4; i += kThreads) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src) + i);
      const int cc = 4 * i / np;
      float* dst = slab + cc * row + (4 * i - cc * np);
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
  } else {
    for (int i = threadIdx.x; i < nc * np; i += kThreads) {
      const int cc = i / np;
      const int pp = i - cc * np;
      slab[cc * row + pp] = __ldg(src + static_cast<size_t>(cc) * hw + pp);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nc / kVec * np; i += kThreads) {
    const int g = i / np;
    const int pp = i - g * np;
    const float* col = slab + g * kVec * row + pp;  // channel g * kVec of pixel pp
    int8_t* dst = q + (static_cast<size_t>(n) * hw + p0 + pp) * c + c0 + g * kVec;
    if constexpr (kVec == 16) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = pack4(col[(4 * k) * row], col[(4 * k + 1) * row], col[(4 * k + 2) * row],
                     col[(4 * k + 3) * row], scale);
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      static_assert(kVec == 4, "kVec is 4 or 16");
      *reinterpret_cast<uint32_t*>(dst) = pack4(col[0], col[row], col[2 * row], col[3 * row], scale);
    }
  }
}

int blocks_for(int n) {
  const int b = (n + kThreads - 1) / kThreads;
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
// eadgan_int8_amax or by the int8_convt kernel that wrote x.  x and q
// 16-byte aligned.
extern "C" int eadgan_int8_quantize(const void* x, const void* amax_bits, void* q, void* scale,
                                    int b, int c, int hw, int nchw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int* bits = static_cast<const unsigned int*>(amax_bits);
  float* sc = static_cast<float*>(scale);
  if (nchw) {
    const int vec = c % 16 == 0 ? 16 : 4;
    const int slab_p = hw < kSlabP ? hw : kSlabP;
    const int per_slab = kSlab / slab_p / vec * vec;  // channels: whole store groups
    const int slab_c = c < per_slab ? c : per_slab;
    const dim3 grid((hw + slab_p - 1) / slab_p, (c + slab_c - 1) / slab_c, b);
    const size_t smem = sizeof(float) * slab_c * (slab_p + 1);
    const float* xf = static_cast<const float*>(x);
    int8_t* q8 = static_cast<int8_t*>(q);
    if (vec == 16) {
      quantize_nchw_kernel<16><<<grid, kThreads, smem, s>>>(xf, bits, q8, sc, c, hw, slab_c, slab_p);
    } else {
      quantize_nchw_kernel<4><<<grid, kThreads, smem, s>>>(xf, bits, q8, sc, c, hw, slab_c, slab_p);
    }
  } else {
    const int n4 = b * c * hw / 4;
    quantize_nhwc_kernel<<<blocks_for((n4 + kUnroll - 1) / kUnroll), kThreads, 0, s>>>(
        static_cast<const float4*>(x), bits, static_cast<uint32_t*>(q), sc, n4);
  }
  return static_cast<int>(cudaGetLastError());
}
