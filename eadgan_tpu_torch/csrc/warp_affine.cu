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
// 128x128 tile: neither means anything here).  A block of 128 threads
// produces 256 consecutive pixels of one image (flat over its rows), each
// thread 2 of them, 128 apart, so that neighbouring threads gather
// neighbouring source pixels in every load.  The grid, (ceil(H*W / 256),
// N), holds 2,048 blocks at the CelebA shape, all resident at once (16 a
// SM, 2,112 places): each SM takes one even share in a single wave.  On
// the card 2 pixels a thread beat 1, 4 and 8 (more threads hide more of
// the gathers' latency, fewer pay the per-thread set-up each).  Each
// thread reads its image's 2x3 map once, into registers.  Per pixel the
// source point comes from the plain version's own formula (no incremental
// coordinates, which would move floor()'s picks), and each channel is the
// plain version's weighted sum in its order, accumulated in float32.  For
// C <= 4 (a template parameter) the block's 256 x C outputs, one
// contiguous run of NHWC, are staged in shared memory and written with
// coalesced 16-byte stores; a run whose bytes are no multiple of 16 or
// misaligned (an odd image size at C = 3) is copied element by element in
// the same kernel, and a C above 4 takes a run-time channel loop writing
// directly.  The kernel is templated on the element type (float, bf16)
// and writes the input's type.
//
// nvcc contracts a*b+c into FMA, so a coordinate may differ from the CPU's
// by an ulp and floor() may pick the neighbouring texel; bilinear output is
// continuous, so the difference stays ~1e-6.  In 'zeros' mode a masked
// tap's index is still clamped, so the read stays in bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kPix = 2;                     // output pixels per thread, kThreads apart
constexpr int kBlockPix = kThreads * kPix;  // consecutive pixels of one image per block

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// the 4 taps of one output pixel: pixel offsets into the image and weights
struct Taps {
  int p00, p01, p10, p11;
  float w00, w01, w10, w11;
};

template <bool kZeros>
__device__ __forceinline__ Taps taps(const float (&t)[6], int i, int j, int h, int w) {
  // pixel centre in normalized coordinates, then the source point
  const float xn = (2.0f * j + 1.0f) / w - 1.0f;
  const float yn = (2.0f * i + 1.0f) / h - 1.0f;
  const float xs = t[0] * xn + t[1] * yn + t[2];
  const float ys = t[3] * xn + t[4] * yn + t[5];
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

  Taps r;
  r.w00 = (1.0f - wy) * (1.0f - wx);
  r.w01 = (1.0f - wy) * wx;
  r.w10 = wy * (1.0f - wx);
  r.w11 = wy * wx;
  if (kZeros) {
    const bool vx0 = x0 >= 0 && x0 < w, vx1 = x1 >= 0 && x1 < w;
    const bool vy0 = y0 >= 0 && y0 < h, vy1 = y1 >= 0 && y1 < h;
    r.w00 = (vy0 && vx0) ? r.w00 : 0.0f;
    r.w01 = (vy0 && vx1) ? r.w01 : 0.0f;
    r.w10 = (vy1 && vx0) ? r.w10 : 0.0f;
    r.w11 = (vy1 && vx1) ? r.w11 : 0.0f;
  }
  // clamped indices: in bounds even where the weight is masked
  const int cx0 = min(max(x0, 0), w - 1), cx1 = min(max(x1, 0), w - 1);
  const int cy0 = min(max(y0, 0), h - 1), cy1 = min(max(y1, 0), h - 1);
  r.p00 = cy0 * w + cx0;
  r.p01 = cy0 * w + cx1;
  r.p10 = cy1 * w + cx0;
  r.p11 = cy1 * w + cx1;
  return r;
}

// one channel, in the plain version's summation order
template <typename T>
__device__ __forceinline__ float sample(const T* img, const Taps& t, int c, int ch) {
  return load_f32(img + t.p00 * c + ch) * t.w00 + load_f32(img + t.p01 * c + ch) * t.w01 +
         load_f32(img + t.p10 * c + ch) * t.w10 + load_f32(img + t.p11 * c + ch) * t.w11;
}

template <typename T, bool kZeros, int C>  // C == 0: the channel count c at run time
__global__ void __launch_bounds__(kThreads)
warp_affine_kernel(const T* __restrict__ img, const float* __restrict__ theta,
                   T* __restrict__ out, int h, int w, int c_run, int theta_stride) {
  const int c = C > 0 ? C : c_run;
  const int n = blockIdx.y;
  const int hw = h * w;
  const int p0 = blockIdx.x * kBlockPix;
  const int npix = min(kBlockPix, hw - p0);

  const float* tp = theta + static_cast<size_t>(theta_stride) * n;
  const float t[6] = {__ldg(tp + 0), __ldg(tp + 1), __ldg(tp + 2),
                      __ldg(tp + 3), __ldg(tp + 4), __ldg(tp + 5)};
  const T* src = img + static_cast<size_t>(n) * hw * c;
  T* dst = out + (static_cast<size_t>(n) * hw + p0) * c;

  if constexpr (C > 0) {
    __shared__ alignas(16) unsigned char staged_raw[kBlockPix * C * sizeof(T)];
    T* staged = reinterpret_cast<T*>(staged_raw);
    // one pixel into the staging buffer; a full block runs it unguarded,
    // so that both pixels' 4 * C gathers are in flight at once
    auto produce = [&](int p) {
      const int i = (p0 + p) / w;
      const Taps tq = taps<kZeros>(t, i, p0 + p - i * w, h, w);
#pragma unroll
      for (int ch = 0; ch < C; ++ch) store(&staged[p * C + ch], sample(src, tq, C, ch));
    };
    if (npix == kBlockPix) {
#pragma unroll
      for (int q = 0; q < kPix; ++q) produce(q * kThreads + threadIdx.x);
    } else {
      for (int q = 0; q < kPix; ++q)
        if (q * kThreads + threadIdx.x < npix) produce(q * kThreads + threadIdx.x);
    }
    __syncthreads();
    const int count = npix * C;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && (count * sizeof(T)) % 16 == 0) {
      const uint4* from = reinterpret_cast<const uint4*>(staged);
      uint4* to = reinterpret_cast<uint4*>(dst);
      for (int k = threadIdx.x; k < static_cast<int>(count * sizeof(T) / 16); k += kThreads)
        to[k] = from[k];
    } else {
      for (int e = threadIdx.x; e < count; e += kThreads) dst[e] = staged[e];
    }
  } else {
    for (int q = 0; q < kPix; ++q) {
      const int p = q * kThreads + threadIdx.x;
      if (p < npix) {
        const int i = (p0 + p) / w;
        const Taps tq = taps<kZeros>(t, i, p0 + p - i * w, h, w);
        for (int ch = 0; ch < c; ++ch) store(dst + p * c + ch, sample(src, tq, c, ch));
      }
    }
  }
}

template <typename T, bool kZeros>
void launch_c(dim3 grid, cudaStream_t s, const T* src, const float* th, T* dst, int h, int w,
              int c, int theta_stride) {
  switch (c) {
    case 1:
      warp_affine_kernel<T, kZeros, 1><<<grid, kThreads, 0, s>>>(src, th, dst, h, w, c, theta_stride);
      break;
    case 2:
      warp_affine_kernel<T, kZeros, 2><<<grid, kThreads, 0, s>>>(src, th, dst, h, w, c, theta_stride);
      break;
    case 3:
      warp_affine_kernel<T, kZeros, 3><<<grid, kThreads, 0, s>>>(src, th, dst, h, w, c, theta_stride);
      break;
    case 4:
      warp_affine_kernel<T, kZeros, 4><<<grid, kThreads, 0, s>>>(src, th, dst, h, w, c, theta_stride);
      break;
    default:
      warp_affine_kernel<T, kZeros, 0><<<grid, kThreads, 0, s>>>(src, th, dst, h, w, c, theta_stride);
  }
}

template <typename T>
int launch(const void* img, const void* theta, void* out, int n, int h, int w,
           int c, int theta_stride, int zeros, void* stream) {
  const dim3 grid((h * w + kBlockPix - 1) / kBlockPix, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* src = static_cast<const T*>(img);
  const float* th = static_cast<const float*>(theta);
  T* dst = static_cast<T*>(out);
  if (zeros) {
    launch_c<T, true>(grid, s, src, th, dst, h, w, c, theta_stride);
  } else {
    launch_c<T, false>(grid, s, src, th, dst, h, w, c, theta_stride);
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
