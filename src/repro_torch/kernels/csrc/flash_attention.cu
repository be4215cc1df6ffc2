// Blockwise online-softmax attention for prefill (sm_90a) on the tensor
// cores, float32 accuracy.
//
// Replaces the Pallas kernel `flash_attention` (body `_flash_kernel`) of
// src/repro/kernels/flash_attention.py:82 (:30), forward only (the TPU
// kernel has no backward); semantics are those of `flash_attention_ref` in
// kernels/ref.py: q [B, Hq, Sq, hd] over k/v [B, Hkv, Skv, hd] at the
// implicit positions arange, query head h reading KV head h / (Hq / Hkv),
// with causal and sliding-window masks -> out [B, Hq, Sq, hd].
//
// Design. One block per 128-row query tile of a (batch row, query head),
// 8 warps of 16 rows each; the grid is flat, query tiles longest first
// (the causal tail does not leave SMs idle at the end) and the heads of a
// KV group adjacent (their K/V tiles meet in L2). The block stages its
// q tile, scaled by 1/sqrt(hd), once in shared memory, and walks the
// 32-key tiles of its KV head through two slots: the next tile's K and V
// arrive by cp.async while this one is used. Each thread splits the
// chunks it copied into TF32 hi and lo in place (hi over the raw value,
// lo beside it), so a tile is split once a block and not once a warp; one
// barrier a tile. Per tile, each warp:
//   1. S [16 x 32] = q kT on the tensor cores, into registers (zeroed
//      accumulators per slice of at most 64 head dims, added in float32);
//   2. the online softmax in registers: a row's 32 scores lie in the four
//      lanes of a quad, its max is two shuffles; the running (m, l) stay
//      in registers (l as each lane's partial sum, reduced at the end);
//   3. O [16 x hd] = alpha O + P v: P goes from the score accumulators
//      straight into the A fragments (no shuffle, no shared memory) with
//      the contraction permuted, A = {c0, c2, c1, c3}, so that k = t and
//      t + 4 are keys 2t and 2t + 1, and V's B fragment is read from those
//      key rows; this tile's P v goes into zeroed accumulators, added to
//      the rescaled O in float32.
// Both products run as mma.sync m16n8k8 TF32 with each float32 operand
// split into hi + lo, three products a step (tf32_mma.cuh), held to the
// plain version's 1e-4 by chip_smoke.py; q and P are split as their A
// fragments are loaded. The products are not predicated: ptxas wraps
// predicated ones in a branch and a WARPSYNC each, which kept it from
// interleaving them. Only tiles that cross the diagonal, the window's edge
// or Skv are masked, by predicate; a warp none of whose rows sees a key of
// such a tile skips it whole, and tiles wholly above the diagonal or
// outside the window are not read.
//
// The tails are masked here, unlike the Pallas kernel, which asserts
// Sq % block_q == 0: query rows past Sq compute on zeros and are not
// written, keys past Skv are masked. A masked score is -1e30 and its weight
// is set to 0 after the exponential; the output is O / max(l, 1e-30). A row
// with no valid key at all (only possible with a window and Sq > Skv) gives
// 0, as the Pallas kernel does; the jnp reference gives the mean of V there.
//
// Shared memory at hd 128: q [128][132] 67584 B and two slots of K hi, K
// lo, V hi, V lo [32][132], 4 x 16896 B each: 202752 B of the 232448 a
// block may have, one block per SM, opted in with
// cudaFuncAttributeMaxDynamicSharedMemorySize. A row stride of hd + 4
// floats (= 4 mod 32) puts the 32 lanes of every fragment load on 32
// banks: q read as A [m][k], K as B stored [n][k], and V at the permuted
// key rows 2t, 2t + 1.
//
// Why mma.sync and not wgmma: TF32 wgmma takes both operands K-major from
// shared memory, so V would be staged transposed, P would make a round
// trip through shared memory, and the hi and lo copies at wgmma's 64-row
// granularity leave no room for a second slot. Its descriptors and
// swizzles are a redesign of their own (ROADMAP).
//
// Bound on the H100: operations. Causal prefill does 4 x Sq (Sq + 1) / 2 x
// hd FLOP per (batch row, query head); taken as three TF32 products at 2048
// TF32 operations per SM per clock, 0.29 ms at q [8, 24, 1024, 128] (the
// bytes, 268 MB, take 0.08 ms). What holds it back (PERF.md, row 6): the
// three mma.sync a step, each product about a fifth of the time (a build
// with one product runs in 60 % of it); 2 warps per scheduler to hide the
// mma.sync latency behind the softmax, the fragment loads and the q and P
// splits, with every warp held to the same phase by the barrier of each
// tile; the split of each K/V tile on its way in.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace libra {

constexpr float kFlashNegInf = -1e30f;
constexpr int kFlashWarps = 8;
constexpr int kFlashThreads = 32 * kFlashWarps;
constexpr int kBQ = 16 * kFlashWarps;  // query rows per block, 16 a warp
constexpr int kBK = 32;                // keys per tile
constexpr int kNK = kBK / 8;           // 8-key n-tiles of a score tile

template <int HD>
struct FlashTile {
  static constexpr int LD = HD + 4;     // row stride of every array (floats)
  static constexpr int KS = HD / 8;     // k-steps of q kT, n-tiles of P v
  // head dims a q kT slice: at most 64 (hd 96: two slices of 48)
  static constexpr int SL = HD <= 64 ? HD : HD / 2;
  static constexpr int kArr = kBK * LD;         // one [kBK][LD] array
  // offsets in floats into dynamic shared memory: q [kBQ][LD], then two
  // slots, each K hi, K lo, V hi, V lo
  static constexpr int kQ = 0;
  static constexpr int kSlots = kQ + kBQ * LD;
  static constexpr int kSlot = 4 * kArr;
  static constexpr int kFloats = kSlots + 2 * kSlot;
  static constexpr int CPR = HD / 4;            // 16-byte chunks a row
  static constexpr int kChunks = 2 * kBK * CPR; // of a K and a V tile
  static_assert(HD % 16 == 0 && SL % 8 == 0 && SL <= 64 && HD % SL == 0,
                "head dim: a multiple of 16, at most 128");
  static_assert(kChunks % kFlashThreads == 0 &&
                    kBQ * CPR % kFlashThreads == 0,
                "every thread copies the same number of chunks");
  static_assert(kFloats * 4 <= 232448, "shared memory of one block");
};

// The thread's i-th 16-byte chunk of a K and V tile: its offset in the
// slot (in K hi or V hi) and its row (key) and column in the tile.
template <int HD>
__device__ __forceinline__ int kv_chunk(int tid, int i, int& r, int& c) {
  using T = FlashTile<HD>;
  const int e = tid + i * kFlashThreads;
  const int x = e / (T::kChunks / 2), w = e - x * (T::kChunks / 2);
  r = w / T::CPR;
  c = 4 * (w - r * T::CPR);
  return 2 * x * T::kArr + r * T::LD + c;
}

// Start copying keys k0 .. k0 + kBK of K and V ([Skv][HD] at kb, vb) into
// K hi and V hi of a slot; keys past skv read as 0.
template <int HD>
__device__ __forceinline__ void copy_kv_tile(float* slot, const float* kb,
                                             const float* vb, int k0,
                                             int skv, int tid) {
  using T = FlashTile<HD>;
#pragma unroll
  for (int i = 0; i < T::kChunks / kFlashThreads; ++i) {
    int r, c;
    const int off = kv_chunk<HD>(tid, i, r, c);
    const bool in = k0 + r < skv;
    const float* src = off >= 2 * T::kArr ? vb : kb;
    cp_async16(slot + off, src + (int64_t)(in ? k0 + r : 0) * HD + c, in);
  }
}

// Split the chunks this thread copied (its copies are complete) in place:
// hi over the raw value, lo into the array after it. The split is made
// once a block, not once a warp.
template <int HD>
__device__ __forceinline__ void split_kv_tile(float* slot, int tid) {
  using T = FlashTile<HD>;
#pragma unroll
  for (int i = 0; i < T::kChunks / kFlashThreads; ++i) {
    int r, c;
    float* p = slot + kv_chunk<HD>(tid, i, r, c);
    const float4 v = *reinterpret_cast<const float4*>(p);
    const float x[4] = {v.x, v.y, v.z, v.w};
    uint32_t hi[4], lo[4];
    split_tf32(x, hi, lo);
    *reinterpret_cast<uint4*>(p) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(p + T::kArr) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// The lane's B fragment at (k0, n0) of a split tile stored [n][k], hi at p
// and lo at p + lo (ld = 4 mod 32) ...
__device__ __forceinline__ void load_bt_split(FragB& f, const float* p,
                                              int lo, int ld, int k0, int n0,
                                              int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* r = p + (n0 + g) * ld + k0 + t;
  f.hi[0] = __float_as_uint(r[0]);
  f.hi[1] = __float_as_uint(r[4]);
  f.lo[0] = __float_as_uint(r[lo]);
  f.lo[1] = __float_as_uint(r[lo + 4]);
}

// ... and of P v's k-step at key row k0 of a split V [key][n], the
// contraction permuted as P's A fragment is: k = t is key k0 + 2t, k = t +
// 4 is key k0 + 2t + 1
__device__ __forceinline__ void load_b_keypairs(FragB& f, const float* p,
                                                int lo, int ld, int k0,
                                                int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* c = p + (k0 + 2 * t) * ld + n0 + g;
  f.hi[0] = __float_as_uint(c[0]);
  f.hi[1] = __float_as_uint(c[ld]);
  f.lo[0] = __float_as_uint(c[lo]);
  f.lo[1] = __float_as_uint(c[lo + ld]);
}

// One key tile for one warp: S = q kT, the online softmax, O = alpha O +
// P v. MASK: the tile crosses the diagonal, the window's edge or Skv.
template <int HD, bool MASK>
__device__ __forceinline__ void flash_tile(
    float (&o)[FlashTile<HD>::KS][4], float (&m_run)[2], float (&l_run)[2],
    const float* qs, const float* slot, int k0, int q0, int skv, int causal,
    int window, int warp, int lane) {
  using T = FlashTile<HD>;
  constexpr int LD = T::LD, KS = T::KS, SL = T::SL, LO = T::kArr;
  const int t = lane & 3, r0 = warp * 16;
  const int qw = q0 + r0 + (lane >> 2);  // rows qw and qw + 8
  // a warp none of whose rows sees a key of the tile skips it whole
  if (MASK && ((causal && k0 > q0 + r0 + 15) ||
               (window > 0 && q0 + r0 - (k0 + kBK - 1) >= window)))
    return;
  const float* ks = slot;
  const float* vs = slot + 2 * T::kArr;

  // 1. S = q kT, a slice of SL head dims at a time
  float s[kNK][4];
#pragma unroll
  for (int d0 = 0; d0 < HD; d0 += SL) {
    float acc[kNK][4];
#pragma unroll
    for (int j = 0; j < kNK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 2  // in full, ptxas spills past 255 registers
    for (int kd = d0; kd < d0 + SL; kd += 8) {
      FragA a;
      load_a(a, qs, LD, r0, kd, lane);
#pragma unroll
      for (int j = 0; j < kNK; ++j) {
        FragB b;
        load_bt_split(b, ks, LO, LD, kd, 8 * j, lane);
        mma3_u(acc[j], a, b);
      }
    }
#pragma unroll
    for (int j = 0; j < kNK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = d0 == 0 ? acc[j][e] : s[j][e] + acc[j][e];
  }

  // 2. the online softmax of rows qw (e = 0, 1) and qw + 8 (e = 2, 3)
  uint32_t ok = 0xffffffffu;
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int j = 0; j < kNK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK) {
        const int kj = k0 + 8 * j + 2 * t + (e & 1);
        const int qi = qw + (e & 2) * 4;
        const bool in = kj < skv && (!causal || qi >= kj) &&
                        (window <= 0 || qi - kj < window);
        if (!in) {
          ok &= ~(1u << (4 * j + e));
          s[j][e] = kFlashNegInf;
        }
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = expf(m_run[r] - mx[r]);
    m_run[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < kNK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = expf(s[j][e] - mx[e >> 1]);
      if (MASK) p = (ok >> (4 * j + e)) & 1u ? p : 0.f;
      s[j][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];

  // 3. O = alpha O + P v, P straight from the score accumulators
  float pv[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < kNK; ++j) {
    FragA a;
    const float x[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
    split_tf32(x, a.hi, a.lo);
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      FragB b;
      load_b_keypairs(b, vs, LO, LD, 8 * j, 8 * n, lane);
      mma3_u(pv[n], a, b);
    }
  }
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[n][e] = fmaf(o[n][e], alpha[e >> 1], pv[n][e]);
}

template <int HD>
__global__ void __launch_bounds__(kFlashThreads, 1) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int hq, int hkv,
    int sq, int skv, int causal, int window) {
  using T = FlashTile<HD>;
  constexpr int LD = T::LD, KS = T::KS;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + T::kQ;
  float* slots = smem + T::kSlots;

  // flat grid: query tile (longest first), then batch row, then head
  const int nq = (sq + kBQ - 1) / kBQ;
  const int bhc = gridDim.x / nq;
  const int rank = blockIdx.x / bhc, rest = blockIdx.x - rank * bhc;
  const int qt = nq - 1 - rank, h = rest % hq, bi = rest / hq;
  const int hk = h / (hq / hkv);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float scale = 1.0f / sqrtf((float)HD);
  const int64_t qbase = ((int64_t)bi * hq + h) * sq * HD;
  const float* kb = k + ((int64_t)bi * hkv + hk) * skv * HD;
  const float* vb = v + ((int64_t)bi * hkv + hk) * skv * HD;

  // the key tiles the block reads: none wholly above the diagonal of its
  // last row, none wholly outside the window of its first
  const int q_last = min(q0 + kBQ, sq) - 1;
  int kt_end = (skv + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, q_last / kBK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window - (kBK - 1) >= 0)
    kt_begin = (q0 - window - (kBK - 1)) / kBK + 1;

  if (kt_begin < kt_end)
    copy_kv_tile<HD>(slots, kb, vb, kt_begin * kBK, skv, tid);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < kBQ * T::CPR / kFlashThreads; ++i) {
    const int e = tid + i * kFlashThreads;
    const int r = e / T::CPR, c = 4 * (e - r * T::CPR);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < sq)
      x = *reinterpret_cast<const float4*>(q + qbase +
                                           (int64_t)(q0 + r) * HD + c);
    *reinterpret_cast<float4*>(qs + r * LD + c) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }

  float o[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {kFlashNegInf, kFlashNegInf}, l_run[2] = {0.f, 0.f};

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    float* slot = slots + ((kt - kt_begin) & 1) * T::kSlot;
    cp_async_wait<0>();
    split_kv_tile<HD>(slot, tid);
    __syncthreads();  // tile kt is split (and q is in); the other slot is
                      // free
    if (kt + 1 < kt_end)
      copy_kv_tile<HD>(slots + ((kt + 1 - kt_begin) & 1) * T::kSlot, kb, vb,
                       (kt + 1) * kBK, skv, tid);
    cp_async_commit();
    const int k0 = kt * kBK;
    const bool edge = k0 + kBK > skv || (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && q_last - k0 >= window);
    if (edge)
      flash_tile<HD, true>(o, m_run, l_run, qs, slot, k0, q0, skv, causal,
                           window, warp, lane);
    else
      flash_tile<HD, false>(o, m_run, l_run, qs, slot, k0, q0, skv, causal,
                            window, warp, lane);
  }

  // l: the quad's partial sums; rows qw and qw + 8 of the warp
  const int qw = q0 + warp * 16 + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qi = qw + 8 * r;
    if (qi >= sq) continue;
    const float denom = fmaxf(l, 1e-30f);
    float* dst = out + qbase + (int64_t)qi * HD + col;
#pragma unroll
    for (int n = 0; n < KS; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
  }
}

template <int HD>
int launch_flash(const float* q, const float* k, const float* v, float* out,
                 int b, int hq, int hkv, int sq, int skv, int causal,
                 int window, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * FlashTile<HD>::kFloats;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = (int64_t)((sq + kBQ - 1) / kBQ) * hq * b;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_attention_kernel<HD><<<(unsigned)blocks, kFlashThreads, smem,
                               stream>>>(q, k, v, out, hq, hkv, sq, skv,
                                         causal, window);
  return (int)cudaGetLastError();
}

}  // namespace libra

extern "C" int libra_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int b, int hq,
                                     int hkv, int sq, int skv, int hd,
                                     int causal, int window,
                                     void* cuda_stream) {
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  float* of = (float*)out;
  cudaStream_t st = (cudaStream_t)cuda_stream;
  switch (hd) {
    case 16:
      return libra::launch_flash<16>(qf, kf, vf, of, b, hq, hkv, sq, skv,
                                     causal, window, st);
    case 32:
      return libra::launch_flash<32>(qf, kf, vf, of, b, hq, hkv, sq, skv,
                                     causal, window, st);
    case 64:
      return libra::launch_flash<64>(qf, kf, vf, of, b, hq, hkv, sq, skv,
                                     causal, window, st);
    case 96:
      return libra::launch_flash<96>(qf, kf, vf, of, b, hq, hkv, sq, skv,
                                     causal, window, st);
    case 128:
      return libra::launch_flash<128>(qf, kf, vf, of, b, hq, hkv, sq, skv,
                                      causal, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
