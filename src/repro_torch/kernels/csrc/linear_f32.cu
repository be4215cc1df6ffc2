// Float32 product out [R, N] = x [R, K] @ w [K, N] on Hopper's tensor cores
// (sm_90a): split-TF32 wgmma fed by TMA, warp-specialised, persistent.
//
// Replaces no TPU kernel: the JAX package leaves its projections to XLA
// (plain dots), and so did the port, to cuBLAS, whose float32 products run
// on the CUDA cores (the configurations say float32, TF32 off). It serves
// the prefill's per-layer projections (models/transformer.py: wq, wk, wv,
// wo and the dense MLP's products); the plain version is torch.matmul,
// which ops.linear_f32 takes for a CPU tensor.
//
// Precision. Each float32 operand is split into TF32 hi = rna(v) and lo =
// rna(v - hi) (tf32_mma.cuh), and a product is taken as lo.hi + hi.lo +
// hi.hi (lo.lo, below 2^-22 of it, is dropped): float32 accuracy at a
// third of the TF32 rate, as flash_attention.cu and mlstm_scan.cu take
// theirs. The tensor core's own accumulation rounds each step, so every
// 32-deep k-tile's products go into zeroed accumulators, and the tiles'
// partial sums are added in float32 registers in k order.
//
// Bound on the H100: operations. 2 R K N FLOP taken as three TF32 products
// at 495 TFLOP/s: at R = 4096, K = 3072, N = 8192, 1.25 ms against 0.15 ms
// for the bytes (each operand read once, the output written once); a
// split-TF32 kernel reads at most a third of the TF32 roofline.
//
// Design. wgmma takes TF32 operands from shared memory only K-major. x
// [R, K] is K-major; w [K, N] is not, and no second copy of the weights is
// kept. So the kernel computes the transposed product, out^T = w^T x^T: A
// (64 features a warpgroup) is read from w's tile into registers and split
// there, B is x's tile, K-major, as TMA lays it. One output tile is 128
// features by 128 rows of x; persistent blocks walk the tiles in bands of
// GROUP row blocks. A block has three warpgroups:
//   - warpgroup 2, warp 0: one thread keeps a ring of STAGES stages in
//     flight by TMA, each a 32-deep k-tile: x [128 rows][32] (16 KB) and w
//     [32][128 features] as four [32][32] boxes (16 KB), all with the
//     128-byte swizzle; rows and columns past R, N and K arrive as zeros;
//   - warpgroup 2, warps 1-3: split each arrived x tile in place into hi,
//     and lo beside it (16 KB), and mark the stage ready;
//   - warpgroups 0 and 1: per stage, load their A fragments from w's tile
//     (the lanes' features chosen so the swizzle puts the 32 lanes of each
//     load on 32 banks), split them, run 12 wgmma m64n128k8 (4 k-steps x
//     3 products; the first zeroes the accumulators), wait, release the
//     stage, add the partial sums into their running sums, and after the
//     last k-tile store the tile (rows past R and features past N are not
//     written).
// The two consumer warpgroups share no barrier, so one's wgmmas fill the
// other's gaps (its A loads, its additions, its epilogue). Shared memory:
// 4 stages x 48 KB = 192 KB. setmaxnreg gives the consumers 224 registers
// (64 accumulators, 64 running sums, 32 A registers) and the splitting
// warpgroup 56.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace libra {
namespace lin {

constexpr int BM = 128;      // features of w a tile: two warpgroups of 64
constexpr int BN = 128;      // rows of x a tile: the wgmma's N
constexpr int BK = 32;       // k a stage: one 128-byte row of float32
constexpr int STAGES = 4;
constexpr int GROUP = 8;     // row blocks a band of the raster
constexpr int THREADS = 384;
constexpr int SPLITTERS = 96;                     // warps 1-3 of warpgroup 2
constexpr int X_BYTES = BN * BK * 4;              // 16 KB, hi; lo beside it
constexpr int W_BOX_BYTES = BK * 32 * 4;          // [32 k][32 features]
constexpr int W_BYTES = BM * BK * 4;              // four boxes
constexpr int STAGE_BYTES = 2 * X_BYTES + W_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 3 * STAGES * 8 + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers and TMA -----------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// a 2-D box of the tensor map at (c0 innermost, c1) into shared memory,
// counted on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------
// Descriptor of a K-major operand under the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (the layout TMA writes); a k-step of
// 8 float32 is 32 bytes further along the row (+2 in the address field).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 rows x 128, the warpgroup's fragment) = a b + (scale_d ? d : 0);
// a is the lane's TF32 A fragment: rows g and g + 8 of the warp's 16, k = t
// and t + 4 (lane = 4 g + t), as mma.sync m16n8k8 holds it
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// keep the compiler from moving a register's uses across the asynchronous
// wgmma that reads or writes it
__device__ __forceinline__ void keep(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void keep(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// tile -> (row block, feature block): bands of GROUP row blocks, each band
// walked feature block by feature block, so the blocks at work at one time
// share x's rows and w's columns in L2
__device__ __forceinline__ void tile_coords(int tile, int nr, int nf,
                                            int& rb, int& fb) {
  const int band = tile / (GROUP * nf);
  const int r0 = band * GROUP;
  const int rows = min(GROUP, nr - r0);
  const int idx = tile - band * GROUP * nf;
  rb = r0 + idx % rows;
  fb = idx / rows;
}

__global__ void __launch_bounds__(THREADS, 1)
    linear_f32_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      float* __restrict__ out, int R, int K, int N) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle's 1024-byte atoms must start on 1024-byte addresses
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = (uint64_t*)(smem + STAGES * STAGE_BYTES);
  uint64_t* ready = full + STAGES;
  uint64_t* empty = ready + STAGES;

  const int nr = (R + BN - 1) / BN, nf = (N + BM - 1) / BM;
  const int nk = (K + BK - 1) / BK;
  const int tiles = nr * nf;
  const int mine = (int)blockIdx.x < tiles
                       ? (tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                             (int)gridDim.x
                       : 0;
  const int iters = mine * nk;   // (tile, k-tile) steps of this block

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], SPLITTERS);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (warp == 0) {
      // ---- producer: one thread keeps the TMA ring full ----
      if (lane != 0) return;
      for (int i = 0; i < iters; ++i) {
        const int s = i % STAGES, n = i / STAGES;
        if (n > 0) mbar_wait(&empty[s], (n - 1) & 1);
        int rb, fb;
        tile_coords((int)blockIdx.x + (i / nk) * (int)gridDim.x, nr, nf, rb,
                    fb);
        const int k0 = (i % nk) * BK;
        uint8_t* st = smem + s * STAGE_BYTES;
        mbar_expect(&full[s], X_BYTES + W_BYTES);
        tma_load(st, &xmap, &full[s], k0, rb * BN);
#pragma unroll
        for (int b = 0; b < BM / 32; ++b)
          tma_load(st + 2 * X_BYTES + b * W_BOX_BYTES, &wmap, &full[s],
                   fb * BM + 32 * b, k0);
      }
    } else {
      // ---- splitters: x's tile -> hi in place, lo beside it ----
      const int ct = threadIdx.x - 256 - 32;
      for (int i = 0; i < iters; ++i) {
        const int s = i % STAGES, n = i / STAGES;
        mbar_wait(&full[s], n & 1);
        float4* hi = (float4*)(smem + s * STAGE_BYTES);
        float4* lo = (float4*)(smem + s * STAGE_BYTES + X_BYTES);
#pragma unroll 2
        for (int v = ct; v < X_BYTES / 16; v += SPLITTERS) {
          const float4 x = hi[v];
          const float in[4] = {x.x, x.y, x.z, x.w};
          uint32_t h[4], l[4];
          split_tf32(in, h, l);
          hi[v] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                              __uint_as_float(h[2]), __uint_as_float(h[3]));
          lo[v] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                              __uint_as_float(l[2]), __uint_as_float(l[3]));
        }
        // the wgmma reads them through the async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&ready[s]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes features 64 wg .. 64 wg + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int g = lane >> 2, t = lane & 3;
  // The lane's A rows g + 8 h of the warp's 16 are the tile's features
  // feat[h]: in w's box 2 wg + warp / 2, 16-byte chunk q_h = 2 (warp & 1) +
  // h + 4 (g / 4), float g % 4 of it. At k = t (+ 4) the swizzle puts chunk
  // q at q ^ k: over the warp's lanes, 32 banks.
  uint32_t aoff[2][2];   // [h][k = t or t + 4]: bytes into the stage's w
  int feat[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = 2 * (warp & 1) + h + 4 * (g >> 2);
    feat[h] = 64 * wg + 32 * (warp >> 1) + 4 * q + (g & 3);
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      const int k = t + 4 * kh;
      aoff[h][kh] = (2 * wg + (warp >> 1)) * W_BOX_BYTES + k * 128 +
                    ((q ^ k) << 4) + (g & 3) * 4;
    }
  }
  float acc[64], sum[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) acc[r] = sum[r] = 0.f;
  uint32_t ahi[4][4], alo[4][4];
  for (int i = 0; i < iters; ++i) {
    const int s = i % STAGES, n = i / STAGES, kt = i % nk;
    mbar_wait(&full[s], n & 1);    // w's tile, read by plain loads
    mbar_wait(&ready[s], n & 1);   // x's tile split
    const uint8_t* st = smem + s * STAGE_BYTES;
    const uint8_t* wt = st + 2 * X_BYTES;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      // A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) at k-step j
      const float v[4] = {*(const float*)(wt + aoff[0][0] + j * 1024),
                          *(const float*)(wt + aoff[1][0] + j * 1024),
                          *(const float*)(wt + aoff[0][1] + j * 1024),
                          *(const float*)(wt + aoff[1][1] + j * 1024)};
      split_tf32(v, ahi[j], alo[j]);
    }
    const uint64_t dh = desc_sw128(smem_u32(st));
    const uint64_t dl = desc_sw128(smem_u32(st + X_BYTES));
#pragma unroll
    for (int r = 0; r < 64; ++r) keep(acc[r]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      wgmma_tf32(acc, alo[j], dh + 2 * j, j > 0);   // j = 0: a fresh tile
      wgmma_tf32(acc, ahi[j], dl + 2 * j, 1);
      wgmma_tf32(acc, ahi[j], dh + 2 * j, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int r = 0; r < 64; ++r) keep(acc[r]);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        keep(ahi[j][r]);
        keep(alo[j][r]);
      }
    if (lane == 0) mbar_arrive(&empty[s]);
    // the k-tiles' partial sums in k order, in float32
#pragma unroll
    for (int r = 0; r < 64; ++r) sum[r] += acc[r];
    if (kt == nk - 1) {
      int rb, fb;
      tile_coords((int)blockIdx.x + (i / nk) * (int)gridDim.x, nr, nf, rb,
                  fb);
      // d[4 j + 2 h + e]: feature feat[h], row 8 j + 2 t + e of the tile
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = fb * BM + feat[h];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = rb * BN + 8 * j + 2 * t + e;
            if (f < N && r < R) out[(size_t)r * N + f] = sum[4 * j + 2 * h + e];
          }
      }
#pragma unroll
      for (int r = 0; r < 64; ++r) sum[r] = 0.f;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point query
// (the library links no libcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
    return (rc == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? (EncodeTiled)p
               : nullptr;
  }();
  return fn;
}

// a float32 [rows, cols] row-major tensor as a map of [box_rows][box_cols]
// boxes (box_cols x 4 = 128 bytes) under the 128-byte swizzle; reads past
// the edges are zeros
bool encode(CUtensorMap* map, const void* base, int rows, int cols,
            int box_rows, int box_cols) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)base, dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace lin
}  // namespace libra

// out [R, N] = x [R, K] @ w [K, N], float32, all row-major and contiguous;
// x and w 16-byte aligned, K and N multiples of 4 (the wrapper checks)
extern "C" int libra_linear_f32(const void* x, const void* w, void* out,
                                int R, int K, int N, void* cuda_stream) {
  using namespace libra::lin;
  if (R <= 0 || K <= 0 || N <= 0 || K % 4 || N % 4)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  if (!encode(&xmap, x, R, K, BN, BK) || !encode(&wmap, w, K, N, BK, 32))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(linear_f32_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  const int tiles = ((R + BN - 1) / BN) * ((N + BM - 1) / BM);
  const int grid = tiles < sms ? tiles : sms;
  linear_f32_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)cuda_stream>>>(
      xmap, wmap, (float*)out, R, K, N);
  return (int)cudaGetLastError();
}
