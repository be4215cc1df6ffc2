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
#include "wgmma_tf32.cuh"

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

using namespace hopper;

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
