// k4 s2 p1 transposed convolution in int8 on the tensor cores, with the
// dequantization, bias and ReLU fused, for Hopper (sm_90a).
//
// Replaces XLA's int8 lowering of eadgan_tpu/ops/quant.py::_convt (a
// lax.conv_general_dilated on int8 operands with int32 results, not a
// Pallas body) at the CelebA generator's three quantized layers, with the
// epilogue of eadgan_tpu/ops/quant.py:182 and the ReLU after it:
//   out = relu(float(acc) * (a_scale * w_scale[co]) + bias[co])
// and two outputs of its own that the layers after it need: the output in
// bf16 (the last int8 layer's, which the bf16 layer 4 reads), and the
// abs-max of what it writes (what the next layer's quantization needs).
//
// Bound: operations.  At batch 128 each layer is 134,217,728 multiply-adds
// an image, 34.4 G int8 operations a batch, 17.4 us at the card's 1,979
// dense int8 TOPS.  The bytes: layer 1 27.3 MB, layer 2 39.8 MB (a float32
// output), layer 3 42.5 MB with its bf16 output, at most 12.7 us at 3.35
// TB/s.  Only wgmma reaches the tensor cores' full int8 rate.
//
// Design: the transposed conv computed directly, not as XLA's convolution
// of a stride-dilated input, whose inserted zeros are 3/4 of its products.
// The output splits by parity into 4 phases: output row oy = 2m + py takes
// kernel row ky = 1 - py + 2ty from input row m + py - ty (ty = 0, 1), and
// columns alike, so each phase is an implicit GEMM with M = B*H*W input-
// grid pixels, N = Cout and K = 4*Cin (4 taps of Cin).  A is the int8
// activation in NHWC; B is the weight repacked once, at model set-up, to
// [phase][Cout][tap][Cin] (ops/quant.py::repack_convt_weight).  Both are
// K-major, as 8-bit wgmma requires.
// - Tiles.  An M tile is 128 consecutive pixels of the input grid: whole
//   rows of W (W divides 128), 128/W rows of one image or several whole
//   images (layer 1: 8 images of 4 x 4; layer 2: 2 of 8 x 8; layer 3: 8
//   rows of 16).  The N tile is the whole of Cout up to 256 (BN = 64, 128
//   or 256).  K walks (tap, 128-channel chunk): each step is one tap and
//   128 channels, 128 bytes, one row of the 128-byte swizzle.
// - A by TMA.  A 4-D tensor map over x, dims (Cin, W, H, B), box (128, W,
//   rows, images), copies a tap for the whole tile: for tap (ty, tx) of
//   phase (py, px) the box starts at (c0, px - tx, y0 + py - ty, b0).  The
//   zero padding of the taps outside the input, the ragged batch and a Cin
//   that is no multiple of 128 are TMA's out-of-bounds zero fill: the math
//   has no masks.
// - B by TMA.  A 4-D map over the repack, dims (Cin, tap, Cout, phase),
//   box (128, 1, BN, 1); the loads ask L2 to keep it (8 MB at layer 1,
//   read by every tile of its phase).
// - Ring.  kStages stages of (A 16 KB, B BN*128 bytes) in dynamic shared
//   memory, each with a full and an empty mbarrier.  One producer thread
//   (warpgroup 2, its registers cut to 40 by setmaxnreg) keeps the TMA
//   loads in flight; two consumer warpgroups (232 registers each) each run
//   wgmma m64nBNk32 s8 x s8 -> s32 on 64 of the tile's pixels, keep one
//   wgmma group in flight and free a stage as soon as the group that read
//   it is done.
// - Persistent grid: one block per SM walks the tiles (phase, M tile, N
//   tile), so one tile's epilogue overlaps the next tile's loads.
// - Epilogue, bit-equal to the plain version: each int32 sum converted
//   with __int2float_rn, the scale __fmul_rn(a_scale, w_scale[co]), then
//   __fadd_rn(__fmul_rn(acc, scale), bias) and fmaxf(., 0), with no FMA
//   contraction; in bf16 one __float2bfloat16_rn, which is torch's
//   x.to(torch.bfloat16) of the float32 value.  128 bytes of columns at a
//   time go into a 128-byte-swizzled shared buffer (two per warpgroup,
//   alternating), then out by one TMA store through a 5-D map that views
//   the output (B, 2H, 2W, Cout) as (Cout, 2 [px], W, 2 [py], B*H), in
//   which a phase's 64 pixels are one box; the map clips the ragged batch.
// - Abs-max: each consumer thread keeps the max of fabsf of what it writes
//   (fabsf: the ReLU may leave -0.0, whose bits would win an unsigned
//   max), the block reduces it and does one atomicMax of the float's bits
//   into a word the host zeroed on the same stream; for values >= 0 the
//   unsigned order of the bits is the float order, so the result is exact
//   in any order.
// - a_scale is read on the card, where the quantize_int8 kernel wrote it:
//   no host sync.  The host encodes the three tensor maps at every call
//   (hopper.cuh).
//
// Requires Cin % 64 == 0 and Cout % 8 == 0 (TMA's 16-byte global strides
// and whole 64-byte chunks of the repack), W dividing 128 and the tile's
// rows fitting the image (128/W rows dividing H, or H dividing 128/W),
// and 16-byte aligned pointers; the wrapper (ops/quant_cuda.py) checks
// them all.

#include <cuda_bf16.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;                      // pixels per M tile
constexpr int kBK = 128;                      // K bytes per step: 128 channels of one tap
constexpr int kConsumers = 2;                 // consumer warpgroups, 64 pixels each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kABytes = kBM * kBK;            // 16 KB
constexpr int kOutBoxBytes = 64 * 128;        // 64 pixels x 128 bytes of channels: 8 KB
constexpr int kOutBufs = 2;                   // output boxes in flight per warpgroup
constexpr int kSwizzleAtom = 1024;            // 8 rows of 128 bytes
constexpr int kRingBytes = 192 * 1024;        // the stages' share of shared memory

template <int BN>
__host__ __device__ constexpr int stages() {
  return kRingBytes / (kABytes + BN * kBK);  // 4, 6 or 8
}

template <int BN>
constexpr int smem_bytes() {
  return stages<BN>() * (kABytes + BN * kBK) + kConsumers * kOutBufs * kOutBoxBytes +
         2 * stages<BN>() * 8 + kSwizzleAtom;  // barriers, and room to align the base
}

struct Plan {
  int h, w;            // the input grid
  int m_total;         // B * H * W pixels
  int tiles_m, tiles_n, tiles;
  int k_chunks;        // 128-channel chunks of Cin
  int cout;
};

struct Tile {
  int py, px, phase;
  int m0;              // first pixel (b * H + y) * W + x of the tile
  int b0, y0;          // its image and row
  int n0;
};

template <int BN>
__device__ __forceinline__ Tile decode(int tile, const Plan& p) {
  Tile t;
  t.n0 = (tile % p.tiles_n) * BN;
  tile /= p.tiles_n;
  t.m0 = (tile % p.tiles_m) * kBM;
  t.phase = tile / p.tiles_m;
  t.py = t.phase >> 1;
  t.px = t.phase & 1;
  const int row = t.m0 / p.w;
  t.b0 = row / p.h;
  t.y0 = row - t.b0 * p.h;
  return t;
}

// keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// A and B, both K-major: rows of 128 bytes, 8-row groups 1024 bytes apart;
// the leading offset is unused within one swizzle row.  A k32 step is 32
// bytes further along the row.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) { return smem_desc(addr, 16, 1024); }

// D (s32) += A (smem, K-major) * B (smem, K-major), 64 x N x 32 of int8;
// with scale_d == 0, D = A * B.  Fragment of thread t (warp w, lane l) of
// the warpgroup: d[4j + 2h + e] is row 16w + l/4 + 8h, column 8j + 2(l%4) + e.
__device__ __forceinline__ void wgmma_m64n64k32(int (&d)[32], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[128], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&d)[BN / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (BN == 64) {
    wgmma_m64n64k32(d, a, b, scale_d);
  } else if constexpr (BN == 128) {
    wgmma_m64n128k32(d, a, b, scale_d);
  } else {
    static_assert(BN == 256, "BN is 64, 128 or 256");
    wgmma_m64n256k32(d, a, b, scale_d);
  }
}

template <int BN, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
int8_convt_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w,
                  const __grid_constant__ CUtensorMap map_out,
                  const float* __restrict__ a_scale, const float* __restrict__ w_scale,
                  const float* __restrict__ bias, unsigned int* __restrict__ amax_bits,
                  const Plan p) {
  constexpr int kStages = stages<BN>();
  constexpr int kBBytes = BN * kBK;
  constexpr bool kF32 = std::is_same<OutT, float>::value;
  constexpr int kChunkCols = 128 / sizeof(OutT);  // columns in 128 bytes: 32 f32 or 64 bf16
  extern __shared__ uint8_t smem_raw[];
  __shared__ float warp_amax[kConsumers * 4];
  // the 128-byte swizzle repeats every 1024 bytes: align every tile to it
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSwizzleAtom - 1) & ~uintptr_t(kSwizzleAtom - 1));
  uint8_t* smem_a = smem;
  uint8_t* smem_b = smem_a + kStages * kABytes;
  uint8_t* smem_out = smem_b + kStages * kBBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_out + kConsumers * kOutBufs * kOutBoxBytes);
  uint64_t* empty = full + kStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);                   // the producer's expect_tx
      mbar_init(&empty[s], kConsumers * 4);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int k_steps = 4 * p.k_chunks;

  if (wg == kConsumers) {
    // producer: one thread issues every load
    setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers * 128) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const Tile t = decode<BN>(tile, p);
        for (int ks = 0; ks < k_steps; ++ks, ++it) {
          const int tap = ks / p.k_chunks;  // 2 * ty + tx
          const int c0 = (ks - tap * p.k_chunks) * kBK;
          const int stage = it % kStages;
          mbar_wait(&empty[stage], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[stage], kABytes + kBBytes);
          tma_load_4d(smem_a + stage * kABytes, &map_x, &full[stage], c0, t.px - (tap & 1),
                      t.y0 + t.py - (tap >> 1), t.b0);
          tma_load_4d(smem_b + stage * kBBytes, &map_w, &full[stage], c0, tap, t.n0, t.phase,
                      kEvictLast);
        }
      }
    }
  } else {
    // consumers: warpgroup wg computes pixels 64*wg .. 64*wg + 63 of the tile
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const uint32_t a_base = smem_u32(smem_a) + wg * 64 * kBK;
    const uint32_t b_base = smem_u32(smem_b);
    const float as = *a_scale;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    float amax = 0.0f;
    uint32_t it = 0;
    uint32_t stores = 0;
    const int colq = (lane % 4) * 2;        // this thread's columns: 8j + colq and 8j + colq + 1
    const int row0 = warp * 16 + lane / 4;  // and row0 + 8, of the warpgroup's 64
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const Tile t = decode<BN>(tile, p);
      int prev = 0;
      for (int ks = 0; ks < k_steps; ++ks, ++it) {
        const int stage = it % kStages;
        mbar_wait(&full[stage], (it / kStages) & 1);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBK / 32; ++k) {
          wgmma_tile<BN>(acc, kmajor_desc(a_base + stage * kABytes + k * 32),
                         kmajor_desc(b_base + stage * kBBytes + k * 32), ks > 0 || k > 0);
        }
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();  // the previous step's group is done: free its stage
        if (ks > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // epilogue, 128 bytes of columns at a time: scale, bias, ReLU (and
      // bf16), swizzled into the shared buffer, then one TMA store of the
      // warpgroup's 64 pixels; rows past the batch are clipped by the
      // store and left out of the abs-max
      const int m_wg = t.m0 + 64 * wg;
      const bool row_ok[2] = {m_wg + row0 < p.m_total, m_wg + row0 + 8 < p.m_total};
      const int bh = m_wg / p.w;  // b * H + y of the warpgroup's first pixel
      const int xs = m_wg - bh * p.w;
#pragma unroll
      for (int c = 0; c < BN / kChunkCols; ++c, ++stores) {
        uint8_t* buf = smem_out + (wg * kOutBufs + stores % kOutBufs) * kOutBoxBytes;
        if (tid == 0) bulk_wait_read<kOutBufs - 1>();  // the store that last used buf has read it
        named_barrier(1 + wg);
#pragma unroll
        for (int jj = 0; jj < kChunkCols / 8; ++jj) {
          const int j = c * (kChunkCols / 8) + jj;
          const int co = t.n0 + 8 * j + colq;
          const bool col_ok = co < p.cout;  // Cout % 8 == 0: co + 1 < Cout too
          float s0 = 0.0f, s1 = 0.0f, b0 = 0.0f, b1 = 0.0f;
          if (col_ok) {
            const float2 ws = __ldg(reinterpret_cast<const float2*>(w_scale + co));
            const float2 bs = __ldg(reinterpret_cast<const float2*>(bias + co));
            s0 = __fmul_rn(as, ws.x);
            s1 = __fmul_rn(as, ws.y);
            b0 = bs.x;
            b1 = bs.y;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + 8 * h;
            float v0 = fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), s0), b0), 0.0f);
            float v1 =
                fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), s1), b1), 0.0f);
            if constexpr (kF32) {
              // 8 bytes at byte 32 jj + 4 colq of the row's 128
              const int byte = 32 * jj + 4 * colq;
              *reinterpret_cast<float2*>(buf + row * 128 + (((byte >> 4) ^ (row & 7)) << 4) +
                                         (byte & 15)) = make_float2(v0, v1);
            } else {
              const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
              *reinterpret_cast<__nv_bfloat162*>(buf + row * 128 + ((jj ^ (row & 7)) << 4) +
                                                 colq * 2) = pair;
              v0 = __low2float(pair);
              v1 = __high2float(pair);
            }
            if (col_ok && row_ok[h]) amax = fmaxf(amax, fmaxf(fabsf(v0), fabsf(v1)));
          }
        }
        fence_proxy_async();
        named_barrier(1 + wg);
        if (tid == 0) {
          tma_store_5d(&map_out, buf, t.n0 + c * kChunkCols, t.px, xs, t.py, bh);
          bulk_commit();
        }
      }
    }
    if (tid == 0) bulk_wait_all();
    if (amax_bits != nullptr) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      if (lane == 0) warp_amax[wg * 4 + warp] = amax;
      named_barrier(1 + kConsumers, 128 * kConsumers);
      if (threadIdx.x == 0) {
#pragma unroll
        for (int w = 1; w < kConsumers * 4; ++w) amax = fmaxf(amax, warp_amax[w]);
        atomicMax(amax_bits, __float_as_uint(amax));
      }
    }
  }
}

// --- host ----------------------------------------------------------------------

// x (batch, h, w, cin) int8: one tap of one M tile, 128 channels x the
// tile's pixels (w columns x rows x images)
bool encode_x(EncodeTiled enc, CUtensorMap* map, const void* x, int batch, int h, int w, int cin,
              int rows, int images) {
  const cuuint64_t dims[4] = {cuuint64_t(cin), cuuint64_t(w), cuuint64_t(h), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(cin), cuuint64_t(w) * cin, cuuint64_t(h) * w * cin};
  const cuuint32_t box[4] = {kBK, cuuint32_t(w), cuuint32_t(rows), cuuint32_t(images)};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(enc, map, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, 4, dims, strides, box, step);
}

// wp (4 phases, cout, 4 taps, cin) int8: 128 channels of one tap x BN Cout of one phase
bool encode_w(EncodeTiled enc, CUtensorMap* map, const void* wp, int cin, int cout, int bn) {
  const cuuint64_t dims[4] = {cuuint64_t(cin), 4, cuuint64_t(cout), 4};
  const cuuint64_t strides[3] = {cuuint64_t(cin), 4ull * cin, 4ull * cin * cout};
  const cuuint32_t box[4] = {kBK, 1, cuuint32_t(bn), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(enc, map, CU_TENSOR_MAP_DATA_TYPE_UINT8, wp, 4, dims, strides, box, step);
}

// out (batch, 2h, 2w, cout) seen as (cout, 2 [px], w, 2 [py], batch * h):
// 128 bytes of channels x one warpgroup's 64 pixels of one phase
bool encode_out(EncodeTiled enc, CUtensorMap* map, void* out, int batch, int h, int w, int cout,
                bool bf16_out) {
  const cuuint64_t e = bf16_out ? 2 : 4;
  const cuuint32_t cols = bf16_out ? 64 : 32;
  const cuuint32_t box_w = w < 64 ? w : 64;
  const cuuint64_t dims[5] = {cuuint64_t(cout), 2, cuuint64_t(w), 2, cuuint64_t(batch) * h};
  const cuuint64_t strides[4] = {cout * e, 2 * cout * e, 2ull * w * cout * e, 4ull * w * cout * e};
  const cuuint32_t box[5] = {cols, 1, box_w, 1, 64 / box_w};
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  return encode(enc, map,
                bf16_out ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, out,
                5, dims, strides, box, step);
}

template <int BN, typename OutT>
int launch(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& mo,
           const float* a_scale, const float* w_scale, const float* bias, unsigned int* amax_bits,
           Plan p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(int8_convt_kernel<BN, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  const int grid = p.tiles < sms ? p.tiles : sms;  // persistent: one block per SM
  int8_convt_kernel<BN, OutT><<<grid, kThreads, smem, stream>>>(mx, mw, mo, a_scale, w_scale, bias,
                                                                amax_bits, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch_bn(int bn, const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& mo,
              const float* a_scale, const float* w_scale, const float* bias,
              unsigned int* amax_bits, Plan p, cudaStream_t s) {
  if (bn == 64) return launch<64, OutT>(mx, mw, mo, a_scale, w_scale, bias, amax_bits, p, s);
  if (bn == 128) return launch<128, OutT>(mx, mw, mo, a_scale, w_scale, bias, amax_bits, p, s);
  return launch<256, OutT>(mx, mw, mo, a_scale, w_scale, bias, amax_bits, p, s);
}

}  // namespace

// out (B, 2H, 2W, Cout) = relu(convt_k4s2p1(x, w) * (a_scale * w_scale) + bias),
// float32, or bf16 when `out_bf16`, from x (B, H, W, Cin) int8 and wp (4,
// Cout, 4, Cin) int8, all contiguous; when amax_bits is not null, the word
// is zeroed on `stream` and receives the bits of max |out|.  Cin % 64 == 0,
// Cout % 8 == 0, W dividing 128 with 128/W rows dividing H or H dividing
// 128/W, every pointer 16-byte aligned; stream is a cudaStream_t.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape outside that
// contract or where no tensor map could be encoded.
extern "C" int eadgan_int8_convt_s2(const void* x, const void* wp, const void* a_scale,
                                    const void* w_scale, const void* bias, void* out,
                                    void* amax_bits, int batch, int h, int w, int cin, int cout,
                                    int out_bf16, void* stream) {
  if (w <= 0 || h <= 0 || kBM % w != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = kBM / w;  // input rows a tile
  if (rows <= h ? h % rows != 0 : rows % h != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tile_rows = rows < h ? rows : h;
  const int images = rows / tile_rows;
  const int bn = cout <= 64 ? 64 : cout <= 128 ? 128 : 256;
  const EncodeTiled enc = encoder();
  CUtensorMap mx, mw, mo;
  if (enc == nullptr || !encode_x(enc, &mx, x, batch, h, w, cin, tile_rows, images) ||
      !encode_w(enc, &mw, wp, cin, cout, bn) ||
      !encode_out(enc, &mo, out, batch, h, w, cout, out_bf16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  p.h = h;
  p.w = w;
  p.m_total = batch * h * w;
  p.tiles_m = (p.m_total + kBM - 1) / kBM;
  p.tiles_n = (cout + bn - 1) / bn;
  p.tiles = 4 * p.tiles_m * p.tiles_n;
  p.k_chunks = (cin + kBK - 1) / kBK;
  p.cout = cout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* bits = static_cast<unsigned int*>(amax_bits);
  if (bits != nullptr) {
    const cudaError_t err = cudaMemsetAsync(bits, 0, sizeof(unsigned int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float* as = static_cast<const float*>(a_scale);
  const float* ws = static_cast<const float*>(w_scale);
  const float* b = static_cast<const float*>(bias);
  if (out_bf16) return launch_bn<bf16>(bn, mx, mw, mo, as, ws, b, bits, p, s);
  return launch_bn<float>(bn, mx, mw, mo, as, ws, b, bits, p, s);
}
