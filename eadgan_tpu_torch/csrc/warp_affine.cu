// Bilinear affine warp of an NHWC batch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of eadgan_tpu/ops/stn_pallas.py:
// `_kernel` (one image per program) and `_kernel_pair` (two images packed
// block-diagonally), both reached through `warp_affine_pallas`.  Same
// function: out[n, i, j, :] samples img[n] at the source point that the
// 2x3 map theta[n] gives for the centre of output pixel (i, j)
// (align_corners=False), with 'border' clamping or 'zeros' masking.
//
// Bound: memory.  Each output element is a weighted sum of 4 input taps,
// about 7 flops per element plus ~25 per pixel for the coordinates, while
// the function must read the image once and write the output once.  At the
// CelebA shape (128, 64, 64, 3) f32 that is 2 x 6.3 MB = 12.6 MB, or about
// 3.8 us at 3.35 TB/s, against under 0.4 us of float32 arithmetic at
// 67 TFLOP/s.  At that size launch overhead dominates.
//
// Design: a direct 4-tap gather, not the TPU's hat-function matrix
// products (those exist to feed the MXU, and the pair packing fills its
// 128x128 tile: neither means anything here).  One thread per output
// pixel on a (ceil(H*W / 256), N) grid; each thread reads the top two
// rows of its image's matrix in place, computes the source point, and
// loops over the C channels of the pixel, which are contiguous in NHWC.
// No grid tensor is materialized.  Neighbouring threads handle
// neighbouring output pixels, so their taps fall on neighbouring input
// pixels and L1/L2 serve the re-reads.  Accumulation is float32; the
// kernel is templated on the element type (float, bf16) and writes the
// input's type.
//
// nvcc contracts a*b+c into FMA, so a coordinate may differ from the CPU's
// by an ulp and floor() may pick the neighbouring texel; bilinear output is
// continuous, so the difference stays ~1e-6.  In 'zeros' mode a masked
// tap's index is still clamped, so the read stays in bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, bool kZeros>
__global__ void __launch_bounds__(kThreads)
warp_affine_kernel(const T* __restrict__ img, const float* __restrict__ theta,
                   T* __restrict__ out, int h, int w, int c, int theta_stride) {
  const int n = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= h * w) return;
  const int i = p / w;
  const int j = p - i * w;

  const float* t = theta + static_cast<size_t>(theta_stride) * n;
  const float t00 = __ldg(t + 0), t01 = __ldg(t + 1), t02 = __ldg(t + 2);
  const float t10 = __ldg(t + 3), t11 = __ldg(t + 4), t12 = __ldg(t + 5);

  // pixel centre in normalized coordinates, then the source point
  const float xn = (2.0f * j + 1.0f) / w - 1.0f;
  const float yn = (2.0f * i + 1.0f) / h - 1.0f;
  const float xs = t00 * xn + t01 * yn + t02;
  const float ys = t10 * xn + t11 * yn + t12;
  float x = (xs + 1.0f) * (w * 0.5f) - 0.5f;
  float y = (ys + 1.0f) * (h * 0.5f) - 0.5f;
  if (!kZeros) {
    x = fminf(fmaxf(x, 0.0f), w - 1.0f);
    y = fminf(fmaxf(y, 0.0f), h - 1.0f);
  }

  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = x - x0f;
  const float wy = y - y0f;
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
  const int x1 = x0 + 1;
  const int y1 = y0 + 1;

  float w00 = (1.0f - wy) * (1.0f - wx);
  float w01 = (1.0f - wy) * wx;
  float w10 = wy * (1.0f - wx);
  float w11 = wy * wx;
  if (kZeros) {
    const bool vx0 = x0 >= 0 && x0 < w, vx1 = x1 >= 0 && x1 < w;
    const bool vy0 = y0 >= 0 && y0 < h, vy1 = y1 >= 0 && y1 < h;
    w00 = (vy0 && vx0) ? w00 : 0.0f;
    w01 = (vy0 && vx1) ? w01 : 0.0f;
    w10 = (vy1 && vx0) ? w10 : 0.0f;
    w11 = (vy1 && vx1) ? w11 : 0.0f;
  }
  // clamped indices: in bounds even where the weight is masked
  const int cx0 = min(max(x0, 0), w - 1), cx1 = min(max(x1, 0), w - 1);
  const int cy0 = min(max(y0, 0), h - 1), cy1 = min(max(y1, 0), h - 1);

  const size_t base = static_cast<size_t>(n) * h * w;
  const T* p00 = img + (base + static_cast<size_t>(cy0) * w + cx0) * c;
  const T* p01 = img + (base + static_cast<size_t>(cy0) * w + cx1) * c;
  const T* p10 = img + (base + static_cast<size_t>(cy1) * w + cx0) * c;
  const T* p11 = img + (base + static_cast<size_t>(cy1) * w + cx1) * c;
  T* o = out + (base + p) * c;
  for (int ch = 0; ch < c; ++ch) {
    // same summation order as the plain version
    const float v = load_f32(p00 + ch) * w00 + load_f32(p01 + ch) * w01 +
                    load_f32(p10 + ch) * w10 + load_f32(p11 + ch) * w11;
    store(o + ch, v);
  }
}

template <typename T>
int launch(const void* img, const void* theta, void* out, int n, int h, int w,
           int c, int theta_stride, int zeros, void* stream) {
  const dim3 grid((h * w + kThreads - 1) / kThreads, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* src = static_cast<const T*>(img);
  const float* th = static_cast<const float*>(theta);
  T* dst = static_cast<T*>(out);
  if (zeros) {
    warp_affine_kernel<T, true><<<grid, kThreads, 0, s>>>(src, th, dst, h, w, c, theta_stride);
  } else {
    warp_affine_kernel<T, false><<<grid, kThreads, 0, s>>>(src, th, dst, h, w, c, theta_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes.  img and out are contiguous
// (N, H, W, C) buffers of the named type; theta holds N contiguous float32
// affine matrices of theta_stride floats each (6 for (N, 2, 3), 9 for
// (N, 3, 3)), of which the first two rows are read; stream is a
// cudaStream_t.  Returns cudaGetLastError().
extern "C" int eadgan_warp_affine_f32(const void* img, const void* theta,
                                      void* out, int n, int h, int w, int c,
                                      int theta_stride, int zeros, void* stream) {
  return launch<float>(img, theta, out, n, h, w, c, theta_stride, zeros, stream);
}

extern "C" int eadgan_warp_affine_bf16(const void* img, const void* theta,
                                       void* out, int n, int h, int w, int c,
                                       int theta_stride, int zeros, void* stream) {
  return launch<__nv_bfloat16>(img, theta, out, n, h, w, c, theta_stride, zeros,
                               stream);
}
