// k4 s2 p1 transposed convolution in int8 on the tensor cores, with the
// dequantization, bias and ReLU fused, for Hopper (sm_90a).
//
// Replaces XLA's int8 lowering of eadgan_tpu/ops/quant.py::_convt (a
// lax.conv_general_dilated on int8 operands with int32 results, not a
// Pallas body) at the CelebA generator's three quantized layers, with the
// epilogue of eadgan_tpu/ops/quant.py:182 and the ReLU after it:
//   out = relu(float(acc) * (a_scale * w_scale[co]) + bias[co])
//
// Bound: at batch 128 each layer is 134,217,728 multiply-adds an image,
// 34.4 G int8 operations a batch, 17.4 us at the card's 1,979 dense int8
// TOPS; layers 1 and 2 move 27.3 and 39.8 MB (bound by operations), layer
// 3 writes a 67 MB float32 output and moves 76.0 MB in all, 22.7 us at
// 3.35 TB/s (bound by bytes).
//
// Design: the transposed conv computed directly, not as XLA's convolution
// of a stride-dilated input, whose inserted zeros are 3/4 of its products.
// The output splits by parity into 4 phases: output row oy = 2m + py takes
// kernel row ky = 1 - py + 2ty from input row m + py - ty (ty = 0, 1), and
// columns alike, so each phase is an implicit GEMM with M = B*H*W output
// pixels, N = Cout and K = 4*Cin (4 taps of Cin), taps outside the input
// zero-filled.  A is the int8 activation in NHWC (K contiguous within a
// tap); B is the weight repacked once, at model set-up, to
// [phase][Cout][tap][Cin] (ops/quant.py::repack_convt_weight), K
// contiguous.  A block computes a 128 x 128 tile of one phase with 8 warps
// (2 x 4, 64 x 32 each) issuing mma.sync m16n8k32 s8 x s8 -> s32 from
// shared tiles of 64 K-bytes filled by cp.async (zero fill for the taps
// outside the input and the ragged M tile), three stages deep.  A smem row
// holds 64 + 16 bytes, so the 32-bit fragment loads of 8 rows x 4 columns
// hit 32 distinct banks.  The epilogue converts each int32 sum to float
// (round to nearest), multiplies by a_scale * w_scale[co] and adds the
// bias with __fmul_rn / __fadd_rn (no FMA contraction), so the output is
// bit-equal to the plain version's for the same int8 inputs, and writes
// NHWC float32 (two channels, 8 bytes, a store).  a_scale is read from
// device memory, where the quantize_int8 kernel wrote it: no host sync.
// wgmma and TMA are left to a later version.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;  // K bytes a stage; Cin % 64 == 0, so a stage never straddles taps
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kRow = kBK + 16;  // smem row stride in bytes
constexpr int kStageA = kBM * kRow;
constexpr int kStageB = kBN * kRow;
constexpr int kSmem = kStages * (kStageA + kStageB);
constexpr int kChunks = kBM * kBK / 16 / kThreads;  // 16-byte copies a thread a stage, A and B each

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
    int8_convt_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wp,
                      const float* __restrict__ a_scale, const float* __restrict__ w_scale,
                      const float* __restrict__ bias, float* __restrict__ out, int batch, int h,
                      int w, int cin, int cout) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* const smem_a = smem;
  uint8_t* const smem_b = smem + kStages * kStageA;

  const int phase = blockIdx.z;
  const int py = phase >> 1;
  const int px = phase & 1;
  const int hw = h * w;
  const int m_total = batch * hw;
  const int k_total = 4 * cin;
  const int k_tiles = k_total / kBK;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp >> 2;  // 0..1: 64 rows each
  const int warp_n = warp & 3;   // 0..3: 32 columns each
  const int g = lane >> 2;
  const int t = lane & 3;

  // each thread copies kChunks 16-byte pieces of A and of B a stage: the
  // rows' pixel coordinates and weight rows, fixed over K
  int a_row[kChunks], a_col[kChunks], a_b[kChunks], a_y[kChunks], a_x[kChunks];
  bool a_ok[kChunks];
  const int8_t* b_src[kChunks];
  bool b_ok[kChunks];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int chunk = tid + j * kThreads;
    a_row[j] = chunk >> 2;
    a_col[j] = (chunk & 3) * 16;
    const int m = m0 + a_row[j];
    a_ok[j] = m < m_total;
    const int mm = a_ok[j] ? m : 0;
    a_b[j] = mm / hw;
    const int r = mm - a_b[j] * hw;
    a_y[j] = r / w;
    a_x[j] = r - a_y[j] * w;
    const int co = n0 + a_row[j];
    b_ok[j] = co < cout;
    b_src[j] = wp + (static_cast<size_t>(phase) * cout + (b_ok[j] ? co : 0)) * k_total + a_col[j];
  }

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    const int tap = k0 / cin;
    const int ci0 = k0 - tap * cin;
    const int dy = py - (tap >> 1);
    const int dx = px - (tap & 1);
    uint8_t* sa = smem_a + stage * kStageA;
    uint8_t* sb = smem_b + stage * kStageB;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int iy = a_y[j] + dy;
      const int ix = a_x[j] + dx;
      const bool ok = a_ok[j] && iy >= 0 && iy < h && ix >= 0 && ix < w;
      const int8_t* src =
          ok ? x + ((static_cast<size_t>(a_b[j]) * h + iy) * w + ix) * cin + ci0 + a_col[j] : x;
      cp_async16(sa + a_row[j] * kRow + a_col[j], src, ok ? 16 : 0);
      cp_async16(sb + a_row[j] * kRow + a_col[j], b_ok[j] ? b_src[j] + k0 : wp, b_ok[j] ? 16 : 0);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt has landed; every warp is done with stage kt - 1
    const int next = kt + kStages - 1;
    if (next < k_tiles) load_stage(next % kStages, next);
    cp_async_commit();

    const uint8_t* sa = smem_a + (kt % kStages) * kStageA;
    const uint8_t* sb = smem_b + (kt % kStages) * kStageB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint8_t* p = sa + (warp_m * 64 + i * 16 + g) * kRow + kk + t * 4;
        af[i][0] = ld32(p);
        af[i][1] = ld32(p + 8 * kRow);
        af[i][2] = ld32(p + 16);
        af[i][3] = ld32(p + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* p = sb + (warp_n * 32 + j * 8 + g) * kRow + kk + t * 4;
        bf[j][0] = ld32(p);
        bf[j][1] = ld32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  const float as = *a_scale;
  const int ho = 2 * h;
  const int wo = 2 * w;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = n0 + warp_n * 32 + j * 8 + t * 2;
    if (co >= cout) continue;  // cout % 8 == 0: co + 1 < cout too
    const float s0 = __fmul_rn(as, w_scale[co]);
    const float s1 = __fmul_rn(as, w_scale[co + 1]);
    const float b0 = bias[co];
    const float b1 = bias[co + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + warp_m * 64 + i * 16 + g + half * 8;
        if (m >= m_total) continue;
        const int n = m / hw;
        const int r = m - n * hw;
        const int my = r / w;
        const int mx = r - my * w;
        const int oy = 2 * my + py;
        const int ox = 2 * mx + px;
        const float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * half]), s0), b0);
        const float v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * half + 1]), s1), b1);
        float2* dst = reinterpret_cast<float2*>(
            out + ((static_cast<size_t>(n) * ho + oy) * wo + ox) * cout + co);
        *dst = make_float2(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
      }
    }
  }
}

}  // namespace

// out (B, 2H, 2W, Cout) f32 = relu(convt_k4s2p1(x, w) * (a_scale * w_scale) + bias)
// from x (B, H, W, Cin) int8 and wp (4, Cout, 4, Cin) int8; Cin % 64 == 0,
// Cout % 8 == 0, x and wp 16-byte aligned.
extern "C" int eadgan_int8_convt_s2(const void* x, const void* wp, const void* a_scale,
                                    const void* w_scale, const void* bias, void* out, int batch,
                                    int h, int w, int cin, int cout, void* stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_convt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int m_total = batch * h * w;
  const dim3 grid((m_total + kBM - 1) / kBM, (cout + kBN - 1) / kBN, 4);
  int8_convt_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wp),
      static_cast<const float*>(a_scale), static_cast<const float*>(w_scale),
      static_cast<const float*>(bias), static_cast<float*>(out), batch, h, w, cin, cout);
  return static_cast<int>(cudaGetLastError());
}
