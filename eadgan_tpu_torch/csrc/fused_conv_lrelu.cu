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
// 3.35 TB/s.  Only wgmma reaches the tensor cores' full rate.
//
// Design: a warp-specialised, persistent implicit GEMM on TMA and wgmma.
// - Tiles.  One M tile is 128 output pixels, 8 rows x 16 columns of one
//   image; the N tile is the whole of Cout up to 256 (BN = 64, 128 or 256;
//   a wider Cout takes several N tiles).  K walks (tap, 64-channel chunk):
//   each step is one tap (kh, kw) and 64 channels, 128 bytes, one row of
//   the 128-byte swizzle.
// - A by TMA.  A 4-D tensor map over x, dims (Cin, W, H, B), element
//   strides (1, 2, 2, 1) and box (64, 32, 16, 1), copies the 64 x 16 x 8
//   elements of one tap for the whole tile: the box for tap (kh, kw)
//   starts at (c0, 2*ow0 - 1 + kw, 2*oh0 - 1 + kh, b).  The zero padding,
//   a Cin that is no multiple of 64 and a ragged image edge are TMA's
//   out-of-bounds zero fill: the math has no masks.
// - B by TMA.  A 3-D map over w viewed as (Cout, Cin, 16 taps) copies
//   BN/64 boxes of 64 Cout x 64 channels; w is HWIO, so B arrives
//   MN-major (Cout contiguous) and wgmma reads it transposed (tnspB = 1).
//   Channels beyond Cin read as zero.
// - Ring.  kStages stages of (A 16 KB, B BN*128 bytes) in dynamic shared
//   memory, each with a full and an empty mbarrier.  One producer thread
//   (warpgroup 2, its registers cut to 40 by setmaxnreg) keeps TMA loads
//   in flight; two consumer warpgroups (232 registers each) each run
//   wgmma m64nBNk16 on 64 of the tile's pixels with float32 accumulators,
//   keep one wgmma group in flight and free a stage as soon as the group
//   that read it is done.
// - Persistent grid: one block per SM walks the tiles, so one tile's
//   epilogue overlaps the next tile's loads.
// - Epilogue: the tile's bias is loaded into registers when the tile
//   starts; then bias and LeakyReLU in float32, one rounding to bf16, 64
//   channels at a time into a 128-byte-swizzled shared buffer (two per
//   warpgroup, alternating), then a TMA store through a map over out
//   (Cout, Wo, Ho, B) that clips the ragged edges.  The stores ask L2 to
//   evict out first and the B loads to keep w.
// - The host encodes the three tensor maps at every call and passes them
//   as __grid_constant__ parameters; cuTensorMapEncodeTiled comes from
//   the CUDA runtime's entry-point lookup, so the library needs no -lcuda.
//
// Requires Cin % 8 == 0 and Cout % 8 == 0 (TMA's 16-byte global strides)
// and 16-byte aligned pointers; the wrapper (ops/fused_conv_cuda.py)
// checks both.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTileH = 8;                     // output rows per M tile
constexpr int kTileW = 16;                    // output columns per M tile
constexpr int kBK = 64;                       // channels per K step: 128 bytes
constexpr int kStages = 4;
constexpr int kConsumers = 2;                 // consumer warpgroups, 64 pixels each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kABytes = kTileH * kTileW * kBK * 2;  // 16 KB
constexpr int kBBoxBytes = 64 * kBK * 2;            // 64 Cout x 64 channels: 8 KB
constexpr int kOutBoxBytes = 64 * 64 * 2;           // 64 pixels x 64 channels: 8 KB
constexpr int kOutBufs = 2;                         // output boxes in flight per warpgroup
constexpr int kSwizzleAtom = 1024;                  // 8 rows of 128 bytes

template <int BN>
constexpr int smem_bytes() {
  return kStages * (kABytes + BN / 64 * kBBoxBytes) + kConsumers * kOutBufs * kOutBoxBytes +
         2 * kStages * 8 + kSwizzleAtom;  // barriers, and room to align the base
}

struct Plan {
  int tiles_h, tiles_w, tiles_n, tiles;  // M tiles per image column/row, N tiles, all
  int k_chunks;                          // 64-channel chunks of Cin
  int cout;
  float slope;
};

// keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A, K-major: 64 pixel rows of 128 bytes, 8-row groups 1024 bytes apart;
// the leading offset is unused within one swizzle row
__device__ __forceinline__ uint64_t a_desc(uint32_t addr) { return smem_desc(addr, 16, 1024); }

// B, MN-major: 64-column blocks of Cout 8 KB apart (leading), 8-row groups
// of K 1024 bytes apart (stride)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return smem_desc(addr, kBBoxBytes, 1024);
}

// D (f32) += A (smem, K-major) * B (smem, MN-major), 64 x N x 16; with
// scale_d == 0, D = A * B.  Fragment of thread t (warp w, lane l) of the
// warpgroup: d[4j + 2h + e] is row 16w + l/4 + 8h, column 8j + 2(l%4) + e.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}


template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (BN == 64) {
    wgmma_m64n64k16(d, a, b, scale_d);
  } else if constexpr (BN == 128) {
    wgmma_m64n128k16(d, a, b, scale_d);
  } else {
    static_assert(BN == 256, "BN is 64, 128 or 256");
    wgmma_m64n256k16(d, a, b, scale_d);
  }
}

struct Tile {
  int b, oh0, ow0, n0;
};

template <int BN>
__device__ __forceinline__ Tile decode(int tile, const Plan& p) {
  Tile t;
  t.n0 = (tile % p.tiles_n) * BN;
  tile /= p.tiles_n;
  t.ow0 = (tile % p.tiles_w) * kTileW;
  tile /= p.tiles_w;
  t.oh0 = (tile % p.tiles_h) * kTileH;
  t.b = tile / p.tiles_h;
  return t;
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
fused_conv_lrelu_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_w,
                        const __grid_constant__ CUtensorMap map_out,
                        const bf16* __restrict__ bias, const Plan p) {
  constexpr int kBBytes = BN / 64 * kBBoxBytes;
  extern __shared__ uint8_t smem_raw[];
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
  const int k_steps = 16 * p.k_chunks;

  if (wg == kConsumers) {
    // producer: one thread issues every load
    setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers * 128) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const Tile t = decode<BN>(tile, p);
        for (int ks = 0; ks < k_steps; ++ks, ++it) {
          const int tap = ks / p.k_chunks;  // kh * 4 + kw
          const int c0 = (ks - tap * p.k_chunks) * kBK;
          const int stage = it % kStages;
          mbar_wait(&empty[stage], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[stage], kABytes + kBBytes);
          tma_load_4d(smem_a + stage * kABytes, &map_x, &full[stage], c0,
                      2 * t.ow0 - 1 + (tap & 3), 2 * t.oh0 - 1 + (tap >> 2), t.b);
#pragma unroll
          for (int i = 0; i < BN / 64; ++i)
            tma_load_3d(smem_b + stage * kBBytes + i * kBBoxBytes, &map_w, &full[stage],
                        t.n0 + 64 * i, c0, tap, kEvictLast);  // w is read by every tile
        }
      }
    }
  } else {
    // consumers: warpgroup wg computes pixels 64*wg .. 64*wg + 63 of the tile
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const uint32_t a_base = smem_u32(smem_a) + wg * 64 * 128;
    const uint32_t b_base = smem_u32(smem_b);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    uint32_t it = 0;
    uint32_t stores = 0;
    const int colq = (lane % 4) * 2;  // this thread's columns: 8j + colq and 8j + colq + 1
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const Tile t = decode<BN>(tile, p);
      // the tile's bias for this thread's columns, loaded now so that the
      // loads are done by the time the epilogue needs them
      __nv_bfloat162 bias2[BN / 8];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = t.n0 + 8 * j + colq;
        bias2[j] = n < p.cout ? *reinterpret_cast<const __nv_bfloat162*>(bias + n)
                              : __floats2bfloat162_rn(0.0f, 0.0f);
      }
      int prev = 0;
      for (int ks = 0; ks < k_steps; ++ks, ++it) {
        const int stage = it % kStages;
        mbar_wait(&full[stage], (it / kStages) & 1);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBK / 16; ++k) {
          // A: 16 channels further along the 128-byte row; B: 16 rows of K
          wgmma_tile<BN>(acc, a_desc(a_base + stage * kABytes + k * 32),
                         b_desc(b_base + stage * kBBytes + k * 16 * 128), ks > 0 || k > 0);
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

      // epilogue, 64 channels at a time: bias, LeakyReLU, bf16, swizzled
      // into the shared buffer, then one TMA store of 4 rows x 16 columns
      const int row0 = warp * 16 + lane / 4;  // and row0 + 8
#pragma unroll
      for (int c = 0; c < BN / 64; ++c, ++stores) {
        uint8_t* buf = smem_out + (wg * kOutBufs + stores % kOutBufs) * kOutBoxBytes;
        if (tid == 0) bulk_wait_read<kOutBufs - 1>();  // the store that last used buf has read it
        named_barrier(1 + wg);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = c * 8 + jj;
          const float b0 = __low2float(bias2[j]);
          const float b1 = __high2float(bias2[j]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + 8 * h;
            float v0 = acc[4 * j + 2 * h] + b0;
            float v1 = acc[4 * j + 2 * h + 1] + b1;
            v0 = v0 >= 0.0f ? v0 : v0 * p.slope;
            v1 = v1 >= 0.0f ? v1 : v1 * p.slope;
            *reinterpret_cast<__nv_bfloat162*>(buf + row * 128 + ((jj ^ (row & 7)) << 4) +
                                               colq * 2) = __floats2bfloat162_rn(v0, v1);
          }
        }
        fence_proxy_async();
        named_barrier(1 + wg);
        if (tid == 0) {
          tma_store_4d(&map_out, buf, t.n0 + 64 * c, t.ow0, t.oh0 + 4 * wg, t.b);
          bulk_commit();
        }
      }
    }
    if (tid == 0) bulk_wait_all();
  }
}

// --- host ----------------------------------------------------------------------

// a bf16 tensor map with the 128-byte swizzle (hopper.cuh::encode)
bool encode_bf16(EncodeTiled enc, CUtensorMap* map, const void* ptr, cuuint32_t rank,
                 const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                 const cuuint32_t* element_strides) {
  return encode(enc, map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, rank, dims, strides, box,
                element_strides);
}

template <int BN>
int launch(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& mo, const bf16* bias,
           Plan p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(fused_conv_lrelu_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  const int grid = p.tiles < sms ? p.tiles : sms;  // persistent: one block per SM
  fused_conv_lrelu_kernel<BN><<<grid, kThreads, smem, stream>>>(mx, mw, mo, bias, p);
  return static_cast<int>(cudaGetLastError());
}

// x (batch, h, h, cin): one tap of one M tile, 64 channels x every other
// column and row (16 x 8 of them) from (c0, 2*ow0 - 1 + kw, 2*oh0 - 1 + kh, b)
bool encode_x(EncodeTiled enc, CUtensorMap* map, const void* x, int batch, int h, int cin) {
  const cuuint64_t e = 2;  // bytes per element
  const cuuint64_t dims[4] = {cuuint64_t(cin), cuuint64_t(h), cuuint64_t(h), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cin * e, h * cin * e, cuuint64_t(h) * h * cin * e};
  const cuuint32_t box[4] = {kBK, 2 * kTileW, 2 * kTileH, 1};
  const cuuint32_t step[4] = {1, 2, 2, 1};
  return encode_bf16(enc, map, x, 4, dims, strides, box, step);
}

// w (4, 4, cin, cout) seen as (16 taps, cin, cout): 64 Cout x 64 channels of one tap
bool encode_w(EncodeTiled enc, CUtensorMap* map, const void* w, int cin, int cout) {
  const cuuint64_t e = 2;
  const cuuint64_t dims[3] = {cuuint64_t(cout), cuuint64_t(cin), 16};
  const cuuint64_t strides[2] = {cout * e, cuuint64_t(cin) * cout * e};
  const cuuint32_t box[3] = {64, kBK, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode_bf16(enc, map, w, 3, dims, strides, box, step);
}

// out (batch, ho, ho, cout): one warpgroup's pixels (4 rows x 16 columns) x 64 Cout
bool encode_out(EncodeTiled enc, CUtensorMap* map, void* out, int batch, int ho, int cout) {
  const cuuint64_t e = 2;
  const cuuint64_t dims[4] = {cuuint64_t(cout), cuuint64_t(ho), cuuint64_t(ho), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cout * e, ho * cout * e, cuuint64_t(ho) * ho * cout * e};
  const cuuint32_t box[4] = {64, kTileW, kTileH / kConsumers, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode_bf16(enc, map, out, 4, dims, strides, box, step);
}

}  // namespace

// Plain C entry point, bound with ctypes.  x: contiguous (batch, h, h, cin)
// bf16; w: contiguous (4, 4, cin, cout) bf16; b: (cout,) bf16; out:
// contiguous (batch, h/2, h/2, cout) bf16; h even, cin and cout multiples
// of 8, every pointer 16-byte aligned; stream is a cudaStream_t.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue where no tensor map could
// be encoded.
extern "C" int eadgan_fused_conv_lrelu_bf16(const void* x, const void* w, const void* b,
                                            void* out, int batch, int h, int cin, int cout,
                                            float slope, void* stream) {
  const EncodeTiled enc = encoder();
  const int ho = h / 2;
  CUtensorMap mx, mw, mo;
  if (enc == nullptr || !encode_x(enc, &mx, x, batch, h, cin) ||
      !encode_w(enc, &mw, w, cin, cout) || !encode_out(enc, &mo, out, batch, ho, cout))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bn = cout <= 64 ? 64 : cout <= 128 ? 128 : 256;
  Plan p;
  p.tiles_h = (ho + kTileH - 1) / kTileH;
  p.tiles_w = (ho + kTileW - 1) / kTileW;
  p.tiles_n = (cout + bn - 1) / bn;
  p.tiles = batch * p.tiles_h * p.tiles_w * p.tiles_n;
  p.k_chunks = (cin + kBK - 1) / kBK;
  p.cout = cout;
  p.slope = slope;
  const bf16* bias = static_cast<const bf16*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 64) return launch<64>(mx, mw, mo, bias, p, s);
  if (bn == 128) return launch<128>(mx, mw, mo, bias, p, s);
  return launch<256>(mx, mw, mo, bias, p, s);
}
