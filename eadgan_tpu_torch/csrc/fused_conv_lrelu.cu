// Fused convolution k4 s2 p1 + bias + LeakyReLU over an NHWC bf16 batch,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of tools/fused_conv_probe.py:
// `_fused_kernel`, reached through `fused_conv_lrelu_pallas`.  Same
// function: out[b, i, j, o] = lrelu(bias[o] + sum over (kh, kw, c) of
// x[b, 2i-1+kh, 2j-1+kw, c] * w[kh, kw, c, o]), taps outside the image
// read as zero, float32 accumulation, one rounding to bf16 at the end.
//
// Bound: operations.  As an implicit GEMM the function is M = B*Ho*Wo
// output pixels by N = Cout by K = 16*Cin.  At the CelebA discriminator's
// second layer, (128, 32, 32, 128) -> (128, 16, 16, 256), that is
// 2*M*N*K = 34.36 GFLOP, 34.7 us at 989 TFLOP/s of dense bf16, against
// 51.4 MB of bytes (x 33.6 MB, out 16.8 MB, w 1.0 MB), 15.3 us at
// 3.35 TB/s.  Only the tensor cores can approach that bound.
//
// Design: implicit GEMM on bf16 tensor cores (WMMA 16x16x16 fragments,
// float32 accumulators).  HWIO `w` viewed as (16*Cin, Cout) is already the
// K x N operand, with k = (kh*4 + kw)*Cin + c.  Each block computes a
// 128 x 128 tile of (pixels x output channels) with 8 warps (4 along M by
// 2 along N, 32 x 64 each), walking K in steps of 32: the A tile is
// gathered from x's receptive fields (8 consecutive channels of one tap
// per 16-byte copy, contiguous in NHWC), the B tile is copied from w, both
// with cp.async into a two-stage shared-memory ring so the next step's
// loads overlap this step's products.  A tap outside the image is a
// zero-filled copy (src-size 0), so padding costs no branch in the math.
// The epilogue adds the bias and applies the LeakyReLU in float32 on each
// 16 x 16 accumulator staged through shared memory, then stores 8 bf16
// (16 bytes) per lane.  The TPU kernel's phase planes, zero halo and
// masked garbage rows (1.27x the FLOPs) exist for the TPU's tiling and are
// not carried over.  wgmma with TMA is the next step to the bound.
//
// Requires Cin % 8 == 0 and Cout % 8 == 0 (16-byte copies) and 16-byte
// aligned pointers; the wrapper (ops/fused_conv_cuda.py) checks both.  A
// Cout that is not a multiple of 128 is masked per 8-channel group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kBM = 128;              // output pixels per block
constexpr int kBN = 128;              // output channels per block
constexpr int kBK = 32;               // reduction depth per pipeline step
constexpr int kThreads = 256;         // 8 warps
constexpr int kAStride = kBK + 8;     // padded smem row (bf16): 80 bytes
constexpr int kBStride = kBN + 8;     // padded smem row (bf16): 272 bytes
constexpr int kATile = kBM * kAStride;
constexpr int kBTile = kBK * kBStride;
constexpr int kCStride = 16 + 4;      // per-warp float32 epilogue tile row

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__global__ void __launch_bounds__(kThreads, 2)
fused_conv_lrelu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const bf16* __restrict__ bias, bf16* __restrict__ out, int h,
                        int cin, int cout, int m_total, float slope) {
  __shared__ __align__(128) bf16 smem_a[2][kATile];
  __shared__ __align__(128) bf16 smem_b[2][kBTile];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 1;  // 0..3: rows wm*32 of the tile
  const int wn = warp & 1;   // 0..1: columns wn*64 of the tile
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int ho = h >> 1;
  const int hw_out = ho * ho;

  // A copies: rows (tid >> 2) and (tid >> 2) + 64, channels (tid & 3) * 8
  const int a_row0 = tid >> 2;
  const int a_kv = (tid & 3) * 8;
  bool a_valid[2];
  int a_ih[2], a_iw[2];
  const bf16* a_img[2];
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + a_row0 + r * 64;
    a_valid[r] = m < m_total;
    const int mm = a_valid[r] ? m : 0;
    const int b = mm / hw_out;
    const int rem = mm - b * hw_out;
    const int oh = rem / ho;
    const int ow = rem - oh * ho;
    a_ih[r] = 2 * oh - 1;
    a_iw[r] = 2 * ow - 1;
    a_img[r] = x + static_cast<size_t>(b) * h * h * cin;
  }
  // B copies: rows (tid >> 4) and (tid >> 4) + 16, channels (tid & 15) * 8
  const int b_row0 = tid >> 4;
  const int b_n = n0 + (tid & 15) * 8;
  const bool b_valid = b_n < cout;

  auto load_tile = [&](int kt, int stage) {
    const int k = kt * kBK + a_kv;
    const int tap = k / cin;
    const int c = k - tap * cin;
    const int kh = tap >> 2;
    const int kw = tap & 3;
    for (int r = 0; r < 2; ++r) {
      const int ih = a_ih[r] + kh;
      const int iw = a_iw[r] + kw;
      const bool ok = a_valid[r] && ih >= 0 && ih < h && iw >= 0 && iw < h;
      const bf16* src = ok ? a_img[r] + (static_cast<size_t>(ih) * h + iw) * cin + c : x;
      cp_async16(&smem_a[stage][(a_row0 + r * 64) * kAStride + a_kv], src, ok);
    }
    for (int r = 0; r < 2; ++r) {
      const int kk = b_row0 + r * 16;
      const bf16* src =
          b_valid ? w + static_cast<size_t>(kt * kBK + kk) * cout + b_n : w;
      cp_async16(&smem_b[stage][kk * kBStride + (tid & 15) * 8], src, b_valid);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int k_tiles = 16 * cin / kBK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) {
      load_tile(kt + 1, (kt + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* a = smem_a[kt & 1];
    const bf16* bt = smem_b[kt & 1];
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm * 32 + i * 16) * kAStride + kk, kAStride);
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], bt + kk * kBStride + wn * 64 + j * 16, kBStride);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: the A ring is free now; each warp stages one 16 x 16
  // accumulator at a time in its own float32 tile, then each lane adds the
  // bias, applies the LeakyReLU and stores 8 channels of one pixel.
  float* scratch = reinterpret_cast<float*>(&smem_a[0][0]) + warp * 16 * kCStride;
  const int r = lane >> 1;
  const int c = (lane & 1) * 8;
  for (int i = 0; i < 2; ++i) {
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], kCStride, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * 32 + i * 16 + r;
      const int n = n0 + wn * 64 + j * 16 + c;
      if (m < m_total && n < cout) {
        const uint4 braw = *reinterpret_cast<const uint4*>(bias + n);
        const bf16* bv = reinterpret_cast<const bf16*>(&braw);
        uint4 packed;
        bf16* pv = reinterpret_cast<bf16*>(&packed);
        for (int e = 0; e < 8; ++e) {
          float v = scratch[r * kCStride + c + e] + __bfloat162float(bv[e]);
          v = v >= 0.0f ? v : v * slope;
          pv[e] = __float2bfloat16(v);
        }
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(m) * cout + n) = packed;
      }
      __syncwarp();
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  x: contiguous (batch, h, h, cin)
// bf16; w: contiguous (4, 4, cin, cout) bf16; b: (cout,) bf16; out:
// contiguous (batch, h/2, h/2, cout) bf16; h even, cin and cout multiples
// of 8, every pointer 16-byte aligned; stream is a cudaStream_t.  Returns
// cudaGetLastError().
extern "C" int eadgan_fused_conv_lrelu_bf16(const void* x, const void* w, const void* b,
                                            void* out, int batch, int h, int cin, int cout,
                                            float slope, void* stream) {
  const int ho = h / 2;
  const int m_total = batch * ho * ho;
  const dim3 grid((m_total + kBM - 1) / kBM, (cout + kBN - 1) / kBN);
  fused_conv_lrelu_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(b),
      static_cast<bf16*>(out), h, cin, cout, m_total, slope);
  return static_cast<int>(cudaGetLastError());
}
