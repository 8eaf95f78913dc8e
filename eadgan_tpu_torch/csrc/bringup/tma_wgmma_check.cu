// Bring-up checks of the TMA + wgmma building blocks of ../fused_conv_lrelu.cu,
// one step at a time, each held against PyTorch on the card by
// `python -m eadgan_tpu_torch.tools.tma_wgmma_check`:
//
// 1. eadgan_check_gemm: a plain (M, K) x (K, N) bf16 product through the
//    kernel's own descriptors (A K-major, B MN-major, both 128-byte
//    swizzled by TMA), wgmma instruction and accumulator fragment layout;
//    B's leading and stride byte offsets are arguments, so a wrong pair
//    shows which one is right.
// 2. eadgan_check_box: the im2col addressing, one A box of the conv's own
//    x tensor map (element strides 2, out-of-bounds zero fill) copied out
//    of shared memory as TMA wrote it, swizzle and all.
//
// Step 3, the persistent warp-specialised schedule, is the conv kernel
// itself against its plain version: the tool's last step, then
// tests/test_torch_port_cuda.py.
//
// Built on its own (not into the package's kernel library) by the tool.

#include "../fused_conv_lrelu.cu"

namespace {

// one 128 x BN tile of C = A * B per block, two warpgroups of 64 rows
template <int BN>
__global__ void __launch_bounds__(256)
gemm_check_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, float* __restrict__ c, int n,
                  int k, uint32_t b_lbo, uint32_t b_sbo) {
  constexpr int kBBytes = BN / 64 * kBBoxBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSwizzleAtom - 1) & ~uintptr_t(kSwizzleAtom - 1));
  uint8_t* smem_a = smem;
  uint8_t* smem_b = smem + kABytes;
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < k / kBK; ++kt) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(&bar, kABytes + kBBytes);
      tma_load_3d(smem_a, &map_a, &bar, kt * kBK, blockIdx.x * 128, 0, kEvictLast);
      for (int i = 0; i < BN / 64; ++i)
        tma_load_3d(smem_b + i * kBBoxBytes, &map_b, &bar, blockIdx.y * BN + 64 * i, kt * kBK, 0,
                    kEvictLast);
    }
    mbar_wait(&bar, kt & 1);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_tile<BN>(acc, a_desc(smem_u32(smem_a) + wg * 64 * 128 + kk * 32),
                     smem_desc(smem_u32(smem_b) + kk * 16 * 128, b_lbo, b_sbo), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    __syncthreads();  // every warpgroup is done with the stage before it is refilled
  }
  const int row0 = blockIdx.x * 128 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        c[static_cast<size_t>(row0 + 8 * h) * n + blockIdx.y * BN + 8 * j + 2 * (lane % 4) + e] =
            acc[4 * j + 2 * h + e];
}

__global__ void box_check_kernel(const __grid_constant__ CUtensorMap map_x,
                                 uint4* __restrict__ out, int c0, int c1, int c2, int c3) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSwizzleAtom - 1) & ~uintptr_t(kSwizzleAtom - 1));
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar, kABytes);
    tma_load_4d(smem, &map_x, &bar, c0, c1, c2, c3);
  }
  mbar_wait(&bar, 0);
  for (int i = threadIdx.x; i < kABytes / 16; i += blockDim.x)
    out[i] = reinterpret_cast<const uint4*>(smem)[i];
}

template <int BN>
int gemm_launch(const CUtensorMap& ma, const CUtensorMap& mb, float* c, int m, int n, int k,
                uint32_t b_lbo, uint32_t b_sbo, cudaStream_t s) {
  // room for B's reads under swapped offsets too, so a wrong pair reads
  // wrong values instead of faulting
  constexpr int smem = kABytes + 2 * 4 * kBBoxBytes + kSwizzleAtom;
  cudaError_t err = cudaFuncSetAttribute(gemm_check_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_check_kernel<BN><<<dim3(m / 128, n / BN), 256, smem, s>>>(ma, mb, c, n, k, b_lbo, b_sbo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: contiguous (m, k) bf16, b: contiguous (k, n) bf16, c: (m, n) float32;
// m % 128 == 0, n % bn == 0, k % 64 == 0, bn in {64, 128, 256}
extern "C" int eadgan_check_gemm(const void* a, const void* b, void* c, int m, int n, int k,
                                 int bn, int b_lbo, int b_sbo, void* stream) {
  const EncodeTiled enc = encoder();
  CUtensorMap ma, mb;
  const cuuint64_t e = 2;
  const cuuint64_t a_dims[3] = {cuuint64_t(k), cuuint64_t(m), 1};
  const cuuint64_t a_strides[2] = {k * e, cuuint64_t(m) * k * e};
  const cuuint32_t a_box[3] = {kBK, 128, 1};
  const cuuint64_t b_dims[3] = {cuuint64_t(n), cuuint64_t(k), 1};
  const cuuint64_t b_strides[2] = {n * e, cuuint64_t(k) * n * e};
  const cuuint32_t b_box[3] = {64, kBK, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  if (enc == nullptr || !encode_bf16(enc, &ma, a, 3, a_dims, a_strides, a_box, step) ||
      !encode_bf16(enc, &mb, b, 3, b_dims, b_strides, b_box, step))
    return static_cast<int>(cudaErrorInvalidValue);
  float* out = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 64) return gemm_launch<64>(ma, mb, out, m, n, k, b_lbo, b_sbo, s);
  if (bn == 128) return gemm_launch<128>(ma, mb, out, m, n, k, b_lbo, b_sbo, s);
  if (bn == 256) return gemm_launch<256>(ma, mb, out, m, n, k, b_lbo, b_sbo, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x: contiguous (batch, h, h, cin) bf16; out: 16 KB, the A box at the
// given coordinates (channel, column, row, image) of the conv's x map
extern "C" int eadgan_check_box(const void* x, void* out, int batch, int h, int cin, int c0, int c1,
                                int c2, int c3, void* stream) {
  const EncodeTiled enc = encoder();
  CUtensorMap mx;
  if (enc == nullptr || !encode_x(enc, &mx, x, batch, h, cin))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = kABytes + kSwizzleAtom;
  box_check_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      mx, static_cast<uint4*>(out), c0, c1, c2, c3);
  return static_cast<int>(cudaGetLastError());
}
