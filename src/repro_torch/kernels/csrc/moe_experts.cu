// The serving paths' MoE experts on Hopper's tensor cores (sm_90a): every
// routed entry's SwiGLU expert and the shared expert in one launch,
// split-TF32 wgmma fed by TMA, warp-specialised, persistent.
//
// Replaces no TPU kernel: the JAX package runs its experts as XLA dots over
// a capacity-bounded [E, C, D] buffer (plain einsums, no Pallas kernel).
// The port's serving paths drop nothing (models/moe.py, moe_ffn_dropless):
// each expert holds a ragged group of rows, whose bounds live on the
// device, and the host never reads them.
//
// What it computes. xs [N, D] holds the routed entries sorted by group,
// group g in rows offsets[g] .. offsets[g + 1] - 1 (G = E + S groups, read
// from device memory), and entry r's output goes to row dest[r] of y. A group g < E is routed expert g; a group E + s is
// block s of the shared expert: its F-wide slice of the S F-wide
// intermediate, which every real row visits (SwiGLU is elementwise over
// the intermediate, so the blocks' outputs sum to the shared expert's). For
// each entry row r of group g:
//   h[r]        = silu(xs[r] w_gate_g) * (xs[r] w_up_g)     [F]
//   y[dest[r]]  = gates[r] * (h[r] w_down_g)                 [D]
// Entries at offsets[G] and past write nothing. The caller passes each
// entry's place in token order as dest, so that a token's rows of y (its
// routed choices and the shared blocks) lie together for it to sum.
//
// Precision: as linear_f32.cu. Each float32 operand is split into TF32 hi
// and lo, a product is lo.hi + hi.lo + hi.hi, each 32-deep k-tile into
// zeroed accumulators, the tiles' partial sums added in float32 in k order.
//
// Design. Work items, in one order for every block, are walked by
// persistent blocks (block b takes items b, b + grid, ...):
//   - phase 1, item (row tile, f): for one group's tile of up to 128 rows
//     (a group's last tile is partial, an empty group has none), features
//     64 f .. 64 f + 63 of gate (warpgroup 0) and of up (warpgroup 1),
//     K = D; warpgroup 1 hands its sums to warpgroup 0 through shared
//     memory, which stores silu(gate) * up into h and counts the item done
//     on the row tile's counter (release);
//   - phase 2, item (row tile, n): output columns 128 n .. 128 n + 127 of
//     the tile's rows, K = F, over h; the producer waits (acquire) until
//     every phase-1 item of the row tile has been counted.
// Every phase-1 item precedes every phase-2 item and no phase-1 item
// waits, so the lowest unfinished item can always run: the launch is
// cooperative, which keeps every block resident. Rows of a tile past its
// group's end are loaded and multiplied (they belong to the next group,
// or hold nothing) but never stored: a product's output column depends on
// its own row only.
//
// A block is linear_f32.cu's: warpgroup 2's warp 0 keeps a ring of STAGES
// TMA stages in flight (x or h [128 rows][32], 16 KB; w as four [32][32]
// boxes, 16 KB, from 3-D maps [group][k][feature] whose edges read as
// zeros, so a box never reaches into the next expert), its warps 1-3 split
// each row tile in place, warpgroups 0 and 1 run 12 wgmma m64n128k8 a
// stage. Shared memory: 4 stages x 48 KB, 32 KB for the gate/up hand-over,
// the group's row-tile prefix.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tf32_mma.cuh"
#include "wgmma_tf32.cuh"

namespace libra {
namespace moe {

using namespace hopper;

constexpr int BM = 128;      // features a tile: two warpgroups of 64
constexpr int BN = 128;      // rows a tile: the wgmma's N
constexpr int BK = 32;       // k a stage: one 128-byte row of float32
constexpr int HALF = 64;     // phase 1: features of gate (and of up) a tile
constexpr int STAGES = 4;
constexpr int THREADS = 384;
constexpr int SPLITTERS = 96;                     // warps 1-3 of warpgroup 2
constexpr int MAX_GROUPS = 256;
constexpr int X_BYTES = BN * BK * 4;              // 16 KB, hi; lo beside it
constexpr int W_BOX_BYTES = BK * 32 * 4;          // [32 k][32 features]
constexpr int W_BYTES = BM * BK * 4;              // four boxes
constexpr int STAGE_BYTES = 2 * X_BYTES + W_BYTES;
constexpr int EX_BYTES = 128 * 64 * 4;            // warpgroup 1's sums
constexpr int TP_BYTES = (MAX_GROUPS + 1) * 4;
constexpr int SMEM_BYTES =
    STAGES * STAGE_BYTES + EX_BYTES + TP_BYTES + 8 + 3 * STAGES * 8 + 1024;

struct Params {
  CUtensorMap xmap;    // xs [N, D], boxes [128 rows][32]
  CUtensorMap hmap;    // h [N, F], boxes [128 rows][32]
  CUtensorMap gmap;    // w_gate [E][D][F], boxes [1][32 k][32 f]
  CUtensorMap umap;    // w_up, as w_gate
  CUtensorMap dmap;    // w_down [E][F][D], boxes [1][32 k][32 n]
  CUtensorMap sgmap;   // shared_gate [D][S][F], boxes [32 k][1][32 f]
  CUtensorMap sumap;   // shared_up, as shared_gate
  CUtensorMap sdmap;   // shared_down [S][F][D], boxes [1][32 k][32 n]
  const int* offsets;  // [G + 1]
  const float* gates;  // [N]
  const long long* dest;  // [N]: entry r's row of y
  float* h;            // [N, F]
  float* y;            // [N, D]
  int* done;           // [row tiles]: phase-1 items counted, zeroed
  int E, G, D, F;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A work item's place: its phase, its row tile (global index rt, group g,
// first row and valid rows) and its feature tile.
struct Item {
  int phase, rt, g, row0, rows, tile;
};

__device__ __forceinline__ Item item_at(int i, int p1, int nf1, int nf2,
                                        const int* tp, const int* offsets,
                                        int G) {
  Item it;
  int j;
  if (i < p1) {
    it.phase = 1;
    it.rt = i / nf1;
    it.tile = i - it.rt * nf1;
  } else {
    j = i - p1;
    it.phase = 2;
    it.rt = j / nf2;
    it.tile = j - it.rt * nf2;
  }
  // the group whose row tiles hold rt: tp[g] <= rt < tp[g + 1]
  int lo = 0, hi = G;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tp[mid] <= it.rt) lo = mid; else hi = mid;
  }
  it.g = lo;
  it.row0 = offsets[lo] + (it.rt - tp[lo]) * BN;
  it.rows = min(BN, offsets[lo + 1] - it.row0);
  return it;
}

__global__ void __launch_bounds__(THREADS, 1)
    moe_experts_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* ex = (float*)(smem + STAGES * STAGE_BYTES);
  int* tp = (int*)(smem + STAGES * STAGE_BYTES + EX_BYTES);
  uint64_t* full = (uint64_t*)(smem + STAGES * STAGE_BYTES + EX_BYTES +
                               TP_BYTES + 4);   // 8-byte aligned
  uint64_t* ready = full + STAGES;
  uint64_t* empty = ready + STAGES;

  const int G = P.G, E = P.E;
  if (threadIdx.x == 0) {
    // row tiles before each group: a group of n rows has ceil(n / BN)
    int acc = 0;
    for (int g = 0; g < G; ++g) {
      tp[g] = acc;
      acc += (P.offsets[g + 1] - P.offsets[g] + BN - 1) / BN;
    }
    tp[G] = acc;
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], SPLITTERS);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int nf1 = (P.F + HALF - 1) / HALF, nf2 = (P.D + BM - 1) / BM;
  const int nk1 = (P.D + BK - 1) / BK, nk2 = (P.F + BK - 1) / BK;
  const int rts = tp[G];
  const int p1 = rts * nf1, items = p1 + rts * nf2;
  const int b = (int)blockIdx.x, grid = (int)gridDim.x;
  // this block's items in each phase, and its stages
  const int mine1 = b < p1 ? (p1 - b + grid - 1) / grid : 0;
  const int mine = b < items ? (items - b + grid - 1) / grid : 0;
  const int iters = mine1 * nk1 + (mine - mine1) * nk2;

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (warp == 0) {
      // ---- producer: one thread keeps the TMA ring full ----
      if (lane != 0) return;
      int s = 0, n = 0;   // stage and its use count
      for (int i = b; i < items; i += grid) {
        const Item it = item_at(i, p1, nf1, nf2, tp, P.offsets, G);
        const bool routed = it.g < E;
        const int nk = it.phase == 1 ? nk1 : nk2;
        if (it.phase == 2) {
          // h's rows of this tile are stored by other blocks' phase 1; a
          // tile never done is a fault: trap (a launch error) rather than
          // hang the card
          for (long long spin = 0; ld_acquire(P.done + it.rt) < nf1; ++spin) {
            if (spin > (1LL << 26)) __trap();
            __nanosleep(128);
          }
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
        }
        for (int kt = 0; kt < nk; ++kt) {
          if (n > 0) mbar_wait(&empty[s], (n - 1) & 1);
          const int k0 = kt * BK;
          uint8_t* st = smem + s * STAGE_BYTES;
          uint8_t* wt = st + 2 * X_BYTES;
          mbar_expect(&full[s], X_BYTES + W_BYTES);
          if (it.phase == 1) {
            tma_load(st, &P.xmap, &full[s], k0, it.row0);
            const int f0 = it.tile * HALF;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              // boxes 0-1: gate's 64 features, 2-3: up's same 64
              const int f = f0 + 32 * (q & 1);
              if (routed)
                tma_load_3d(wt + q * W_BOX_BYTES, q < 2 ? &P.gmap : &P.umap,
                            &full[s], f, k0, it.g);
              else
                tma_load_3d(wt + q * W_BOX_BYTES, q < 2 ? &P.sgmap : &P.sumap,
                            &full[s], f, it.g - E, k0);
            }
          } else {
            tma_load(st, &P.hmap, &full[s], k0, it.row0);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int c = it.tile * BM + 32 * q;
              if (routed)
                tma_load_3d(wt + q * W_BOX_BYTES, &P.dmap, &full[s], c, k0,
                            it.g);
              else
                tma_load_3d(wt + q * W_BOX_BYTES, &P.sdmap, &full[s], c, k0,
                            it.g - E);
            }
          }
          if (++s == STAGES) {
            s = 0;
            ++n;
          }
        }
      }
    } else {
      // ---- splitters: each row tile -> hi in place, lo beside it ----
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
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&ready[s]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes features 64 wg .. 64 wg + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int g8 = lane >> 2, t = lane & 3;
  const int tid = threadIdx.x % 128;
  uint32_t aoff[2][2];   // [h][k = t or t + 4]: bytes into the stage's w
  int feat[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = 2 * (warp & 1) + h + 4 * (g8 >> 2);
    feat[h] = 32 * (warp >> 1) + 4 * q + (g8 & 3);   // within the warpgroup
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      const int k = t + 4 * kh;
      aoff[h][kh] = (2 * wg + (warp >> 1)) * W_BOX_BYTES + k * 128 +
                    ((q ^ k) << 4) + (g8 & 3) * 4;
    }
  }
  float acc[64], sum[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) acc[r] = sum[r] = 0.f;
  uint32_t ahi[4][4], alo[4][4];
  int i = 0;   // stage counter
  for (int w = b; w < items; w += grid) {
    const Item it = item_at(w, p1, nf1, nf2, tp, P.offsets, G);
    const int nk = it.phase == 1 ? nk1 : nk2;
    for (int kt = 0; kt < nk; ++kt, ++i) {
      const int s = i % STAGES, n = i / STAGES;
      mbar_wait(&full[s], n & 1);
      mbar_wait(&ready[s], n & 1);
      const uint8_t* st = smem + s * STAGE_BYTES;
      const uint8_t* wt = st + 2 * X_BYTES;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
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
        wgmma_tf32(acc, alo[j], dh + 2 * j, j > 0);
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
#pragma unroll
      for (int r = 0; r < 64; ++r) sum[r] += acc[r];
    }
    // d[4 j + 2 h + e]: feature feat[h], row 8 j + 2 t + e of the tile
    if (it.phase == 1) {
      // warpgroup 1 (up) hands its sums over; warpgroup 0 (gate) stores
      // silu(gate) * up
      if (wg == 1) {
#pragma unroll
        for (int r = 0; r < 64; ++r) ex[r * 128 + tid] = sum[r];
      }
      named_sync(1, 256);
      if (wg == 0) {
#pragma unroll
        for (int r = 0; r < 64; ++r) {
          const float gv = sum[r];
          sum[r] = gv / (1.f + expf(-gv)) * ex[r * 128 + tid];
        }
      }
      named_sync(2, 256);
      if (wg == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = it.tile * HALF + feat[h];
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = 8 * j + 2 * t + e;
              if (f < P.F && r < it.rows)
                P.h[(size_t)(it.row0 + r) * P.F + f] = sum[4 * j + 2 * h + e];
            }
        }
        // the stores, seen by the TMA loads of other blocks' phase 2
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        __threadfence();
        named_sync(3, 128);
        if (tid == 0) red_release_add(P.done + it.rt, 1);
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = it.tile * BM + 64 * wg + feat[h];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 8 * j + 2 * t + e;
            if (c < P.D && r < it.rows) {
              const int row = it.row0 + r;
              P.y[(size_t)P.dest[row] * P.D + c] =
                  P.gates[row] * sum[4 * j + 2 * h + e];
            }
          }
      }
    }
#pragma unroll
    for (int r = 0; r < 64; ++r) sum[r] = 0.f;
  }
}

}  // namespace moe
}  // namespace libra

// y [N, D] of the grouped SwiGLU experts (the file's comment); dest [N]
// int64, a permutation of y's rows; xs, the weights and y float32, row-major, contiguous and 16-byte aligned, D and
// F multiples of 4 (the wrapper checks). offsets [E + S + 1] int32 on the
// device, h [N, F] scratch, done [rows / 128 + E + S] int32 scratch (zeroed
// here). The shared pointers are null where S is 0.
extern "C" int libra_moe_experts(const void* xs, const void* offsets,
                                 const void* gates, const void* dest,
                                 const void* w_gate,
                                 const void* w_up, const void* w_down,
                                 const void* shared_gate,
                                 const void* shared_up,
                                 const void* shared_down, void* h, void* y,
                                 void* done, int N, int D, int F, int E, int S,
                                 void* cuda_stream) {
  using namespace libra::moe;
  const int G = E + S;
  if (N <= 0 || D <= 0 || F <= 0 || E <= 0 || S < 0 || G > MAX_GROUPS ||
      D % 4 || F % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)cuda_stream;
  Params p;
  const long long f4 = 4LL * F, d4 = 4LL * D;
  bool ok = encode(&p.xmap, xs, N, D, BN, BK) &&
            encode(&p.hmap, h, N, F, BN, BK) &&
            encode_3d(&p.gmap, w_gate, F, D, E, f4, f4 * D, 32, BK, 1) &&
            encode_3d(&p.umap, w_up, F, D, E, f4, f4 * D, 32, BK, 1) &&
            encode_3d(&p.dmap, w_down, D, F, E, d4, d4 * F, 32, BK, 1);
  if (S > 0) {
    ok = ok &&
         encode_3d(&p.sgmap, shared_gate, F, S, D, f4, f4 * S, 32, 1, BK) &&
         encode_3d(&p.sumap, shared_up, F, S, D, f4, f4 * S, 32, 1, BK) &&
         encode_3d(&p.sdmap, shared_down, D, F, S, d4, d4 * F, 32, BK, 1);
  } else {
    p.sgmap = p.gmap;   // never read: no group is a shared block
    p.sumap = p.umap;
    p.sdmap = p.dmap;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  p.offsets = (const int*)offsets;
  p.gates = (const float*)gates;
  p.dest = (const long long*)dest;
  p.h = (float*)h;
  p.y = (float*)y;
  p.done = (int*)done;
  p.E = E;
  p.G = G;
  p.D = D;
  p.F = F;
  const int row_tiles = N / BN + G;
  cudaError_t rc =
      cudaMemsetAsync(done, 0, (size_t)row_tiles * sizeof(int), stream);
  int dev = 0, sms = 0, per_sm = 0;
  if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(moe_experts_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, moe_experts_kernel, THREADS, SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // phase 2 waits on phase 1 of other blocks: every block resident
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sms * per_sm);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, moe_experts_kernel, p);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

// ---- routing ----------------------------------------------------------------
// The entries of moe_experts_kernel, made on the device in one call of
// libra_moe_route: from the router's logits [T, Ep] (experts at E and past
// are padding, never chosen), each valid row's top k experts by softmax
// probability (raw, or renormalised over the k), and its S shared blocks
// gated by sigmoid(x w_gp); the entries counted by group, the counts
// scanned into offsets, and each entry scattered to a place in its group
// with its row of x copied there. Places within a group follow no order
// (atomic counters): each entry's output is its own whatever its place,
// and dest carries it back to token order. Where a ring is given, the scan
// also notes how many routed experts (groups below E) the call's entries
// reach, at reached[cursor % ring], the cursor kept at reached[ring]: the
// experts whose weights moe_experts_kernel reads.

namespace libra {
namespace moe {

constexpr int ROUTE_THREADS = 256;
constexpr int MAX_E = 256;   // experts (padding included) a router has

struct RouteParams {
  const float* logits;   // [T, Ep]
  const float* x;        // [T, D]
  const float* w_gp;     // [D], or null where S is 0
  const bool* valid;     // [T], or null: every row
  int* ids;              // [T, width] scratch: each entry's group
  float* gates_tok;      // [T, width] scratch: each entry's gate
  int* counts;           // [G]: entries a group, zeroed
  int* cursor;           // [G]
  int* offsets;          // [G + 1]
  long long* dest;       // [T * width]
  float* gates;          // [T * width]
  float* xs;             // [T * width, D]
  int* reached;          // [ring + 1], or null: the experts reached a call
  int T, Ep, E, k, S, D, norm, ring;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// one warp a row: softmax, top k, the shared gate, the counts
__global__ void __launch_bounds__(ROUTE_THREADS)
    moe_route_kernel(const __grid_constant__ RouteParams P) {
  const int t = (blockIdx.x * ROUTE_THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (t >= P.T || (P.valid != nullptr && !P.valid[t])) return;
  const int width = P.k + P.S;
  const float* l = P.logits + (size_t)t * P.Ep;
  float v[MAX_E / 32];
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < MAX_E / 32; ++i) {
    const int e = lane + 32 * i;
    v[i] = e < P.E ? l[e] : -CUDART_INF_F;
    mx = fmaxf(mx, v[i]);
  }
  mx = warp_max(mx);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_E / 32; ++i)
    if (lane + 32 * i < P.E) sum += expf(v[i] - mx);
  sum = warp_sum(sum);
  float picked = 0.f;
  int* ids = P.ids + (size_t)t * width;
  float* gates = P.gates_tok + (size_t)t * width;
  for (int j = 0; j < P.k; ++j) {
    // the largest logit not yet taken; ties to the lower expert
    float best = -CUDART_INF_F;
    int bi = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < MAX_E / 32; ++i) {
      const int e = lane + 32 * i;
      if (e < P.E && v[i] > best) {
        best = v[i];
        bi = e;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(~0u, best, o);
      const int oi = __shfl_xor_sync(~0u, bi, o);
      if (ob > best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
    }
#pragma unroll
    for (int i = 0; i < MAX_E / 32; ++i)
      if (lane + 32 * i == bi) v[i] = -CUDART_INF_F;
    const float prob = expf(best - mx) / sum;
    picked += prob;
    if (lane == 0) {
      ids[j] = bi;
      gates[j] = prob;
      atomicAdd(P.counts + bi, 1);
    }
  }
  if (P.norm && lane == 0)
    for (int j = 0; j < P.k; ++j) gates[j] /= fmaxf(picked, 1e-9f);
  if (P.S > 0) {
    float dot = 0.f;
    const float* xr = P.x + (size_t)t * P.D;
    for (int i = lane; i < P.D; i += 32) dot += xr[i] * P.w_gp[i];
    dot = warp_sum(dot);
    const float sg = 1.f / (1.f + expf(-dot));
    if (lane < P.S) {
      ids[P.k + lane] = P.Ep + lane;
      gates[P.k + lane] = sg;
      atomicAdd(P.counts + P.Ep + lane, 1);
    }
  }
}

// the groups' offsets and cursors: an exclusive scan of the counts
__global__ void moe_scan_kernel(const __grid_constant__ RouteParams P) {
  if (threadIdx.x != 0) return;
  const int G = P.Ep + P.S;
  int acc = 0;
  for (int g = 0; g < G; ++g) {
    P.offsets[g] = acc;
    P.cursor[g] = acc;
    acc += P.counts[g];
  }
  P.offsets[G] = acc;
  if (P.reached != nullptr) {
    int n = 0;
    for (int g = 0; g < P.E; ++g) n += P.counts[g] > 0;
    const unsigned at = (unsigned)P.reached[P.ring];
    P.reached[at % (unsigned)P.ring] = n;
    P.reached[P.ring] = (int)(at + 1u);
  }
}

// one warp an entry: its place in its group, its gate, token-order row and
// its row of x
__global__ void __launch_bounds__(ROUTE_THREADS)
    moe_scatter_kernel(const __grid_constant__ RouteParams P) {
  const int width = P.k + P.S;
  const long long n = (long long)blockIdx.x * ROUTE_THREADS / 32 +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (n >= (long long)P.T * width) return;
  const int t = (int)(n / width);
  if (P.valid != nullptr && !P.valid[t]) return;
  int pos = 0;
  if (lane == 0) {
    pos = atomicAdd(P.cursor + P.ids[n], 1);
    P.dest[pos] = n;
    P.gates[pos] = P.gates_tok[n];
  }
  pos = __shfl_sync(~0u, pos, 0);
  const float4* src = (const float4*)(P.x + (size_t)t * P.D);
  float4* dst = (float4*)(P.xs + (size_t)pos * P.D);
  for (int i = lane; i < P.D / 4; i += 32) dst[i] = src[i];
}

}  // namespace moe
}  // namespace libra

// The routing of the serving paths' dropless MoE layer (the section's
// comment): xs [T * (k + S), D], offsets [Ep + S + 1] int32, gates and
// dest [T * (k + S)] (float32, int64) for moe_experts_kernel, from logits
// [T, Ep] and x [T, D] (float32, contiguous, 16-byte aligned, D a multiple
// of 4; the wrapper checks). w_gp [D] is null where S is 0, valid [T]
// (bool) null where every row is routed; scratch [2 T (k + S) + 2 (Ep +
// S)] int32; reached [ring + 1] int32, or null.
extern "C" int libra_moe_route(const void* logits, const void* x,
                               const void* w_gp, const void* valid,
                               void* xs, void* offsets, void* gates,
                               void* dest, void* scratch, void* reached,
                               int T, int Ep, int E, int k, int S, int D,
                               int norm, int ring, void* cuda_stream) {
  using namespace libra::moe;
  const int G = Ep + S, width = k + S;
  if (T <= 0 || E <= 0 || E > Ep || Ep > MAX_E || k <= 0 || k > E ||
      k > 32 || S < 0 || S > 32 || G > MAX_GROUPS || D <= 0 || D % 4 ||
      (S > 0 && w_gp == nullptr) || (reached != nullptr && ring <= 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)cuda_stream;
  RouteParams p;
  p.logits = (const float*)logits;
  p.x = (const float*)x;
  p.w_gp = (const float*)w_gp;
  p.valid = (const bool*)valid;
  int* s = (int*)scratch;
  const size_t n = (size_t)T * width;
  p.ids = s;
  p.gates_tok = (float*)(s + n);
  p.counts = s + 2 * n;
  p.cursor = s + 2 * n + G;
  p.offsets = (int*)offsets;
  p.dest = (long long*)dest;
  p.gates = (float*)gates;
  p.xs = (float*)xs;
  p.T = T;
  p.Ep = Ep;
  p.E = E;
  p.k = k;
  p.S = S;
  p.D = D;
  p.norm = norm;
  p.reached = (int*)reached;
  p.ring = ring;
  cudaError_t rc = cudaMemsetAsync(p.counts, 0, G * sizeof(int), stream);
  if (rc != cudaSuccess) return (int)rc;
  const int warps = ROUTE_THREADS / 32;
  moe_route_kernel<<<(T + warps - 1) / warps, ROUTE_THREADS, 0, stream>>>(p);
  moe_scan_kernel<<<1, 32, 0, stream>>>(p);
  const long long blocks = ((long long)n + warps - 1) / warps;
  moe_scatter_kernel<<<(unsigned)blocks, ROUTE_THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}
