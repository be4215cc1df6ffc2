// Stabilised chunkwise-parallel mLSTM scan (sm_90a) on the tensor cores.
//
// Replaces the Pallas kernel `mlstm_scan` (body `_mlstm_kernel`) of
// src/repro/kernels/mlstm_scan.py:73 (:26); semantics are those of
// `mlstm_chunked_ref` in kernels/ref.py, the twin of the JAX package's
// `mlstm_cell_chunked` (models/ssm.py:201): q/k/v [B, H, S, dh] and the
// gates log_i/log_f [B, H, S] (log_f log-sigmoided) -> h [B, H, S, dh],
// plus the final state C [B, H, dh, dh], n [B, H, dh] and m [B, H], which
// the TPU kernel keeps in VMEM scratch and drops. S need not be a multiple
// of the chunk: rows past S read as the JAX function's padding (q, k, v 0,
// log_i -1e30, log_f 0) and are not written.
//
// Design. The TPU kernel holds the whole C [dh, dh] in VMEM, 1 MiB at dh
// 512; a block has at most 227 KB of shared memory. So the grid is
// (B*H, dh/DV): each block keeps a [dh, DV] tile of C (DV = 64) and walks
// the chunks of its (row, head) in order, the TPU's "arbitrary" chunk axis.
// Per chunk, 8 warps:
//   0. warp 0: the gates, cumsum A of log_f, the row stabiliser m_loc (a
//      shuffle max-scan), the end-of-chunk m_new and decay, the key
//      weights w = exp(A_T - A_s + li_s - m_new) / sqrt(dh);
//   1. q kT [c, c] and q C [c, DV] in one k-loop over the head dim, 64 dims
//      a slice, and q.n;
//   2. P = exp(W - m_loc) q kT / sqrt(dh) through shared memory, P v
//      accumulated onto e_inter q C, h = that / max(|den|, exp(-m_loc));
//   3. C = decay C + kT (w v) in bands of 128 rows of C, n = decay n + kT w.
// The four products run on the tensor cores, mma.sync m16n8k8 TF32 with
// each float32 operand split as hi + lo (three products a step): float32
// accuracy, held to the plain version's bars (5e-4) by chip_smoke.py. The
// q/k slices and the k bands stream through two slots by cp.async, the
// next one in flight while the current one is used; v and the next chunk's
// gates ride along. Every tile is padded or swizzled so that a fragment
// load hits 32 banks.
//
// Why mma.sync and not wgmma: wgmma reads its B operand from shared
// memory. The B operand of q C is the block's C tile, 128 KB in float32 at
// dh 512; split copies C_hi and C_lo would take 256 KB of the 227 KB.
// mma.sync takes both operands from registers: the split is made as a
// fragment is loaded, and C stays one float32 copy.
//
// Shared memory at dh 512, chunk 64: C 131072 B (unpadded, swizzled), two
// slots of 34816 B (q and k slices [64][68]; P [64][68]; a raw k band
// [64][136]), the v tile 18432 B ([64][72]), gates, n and m 3856 B:
// 222992 B of the 232448 a block may have, one block per SM, opted in with
// cudaFuncAttributeMaxDynamicSharedMemorySize.
//
// Bound on the H100: operations. Per (row, head, chunk) the function does
// 2 (c(c+1)/2 dh + c(c+1)/2 dh + c dh^2 + c dh^2) FLOP over the causal
// triangle (q kT, P v, q C, kT (w v)); taken as three TF32 products at 2048
// TF32 operations per SM per clock, 0.82 ms at B=8 H=4 S=4096 dh=512 (the
// bytes, 1.11 GB, take 0.33 ms). What holds it back (PERF.md, row 7): the
// chunks of a (row, head) run in order at one block (8 warps) per SM, with
// about 30 barriers a chunk; q kT is recomputed in each of the dh/64 = 8
// blocks of a head (20 of step 1's 52 tiles); the split takes five
// CUDA-core instructions per operand element, about four per mma.sync in
// step 1's loop with the fragment loads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace libra {

constexpr float kMlstmNegInf = -1e30f;
constexpr int kMlstmThreads = 256;  // 8 warps

template <int CH, int HD>
struct MlstmTile {
  static constexpr int DV = HD < 64 ? HD : 64;  // value columns per block
  static constexpr int DK = HD < 64 ? HD : 64;  // q/k dims per step 1 slice
  static constexpr int DU = HD < 128 ? HD : 128;  // rows of C per step 3 band
  // row strides (floats): = 4 mod 32 for tiles read as A [m][k] or as B
  // [n][k], = 8 or 24 mod 32 for tiles read as B [k][n] or as A [k][m]
  static constexpr int LDQ = DK + 4;            // q, k slice [CH][LDQ]
  static constexpr int LDP = CH + 4;            // P [CH][LDP]
  static constexpr int LDV = DV + 8;            // v tile [CH][LDV]
  static constexpr int LDU = DU + 8;            // raw k band [CH][LDU]
  // steps 1 and 2: q kT [CH, CH] (NK1 8-column tiles) and q C [CH, DV]
  // (NC1) over WM1 x WN1 warps; a warp takes TM1 16-row tiles by TK1 q kT
  // and TC1 q C column tiles, columns strided by WN1
  static constexpr int MT1 = CH / 16, NK1 = CH / 8, NC1 = DV / 8;
  static constexpr int WM1 = MT1 < 2 ? MT1 : 2, WN1 = 8 / WM1;
  static constexpr int TM1 = MT1 / WM1;
  static constexpr int TK1 = (NK1 + WN1 - 1) / WN1;
  static constexpr int TC1 = (NC1 + WN1 - 1) / WN1;
  // step 3 over a [DU, DV] band of C: WM3 x WN3 warps, TM3 x TN3 tiles each
  static constexpr int MT3 = DU / 16, NT3 = DV / 8;
  static constexpr int WM3 = MT3 < 4 ? MT3 : 4, WN3 = 8 / WM3;
  static constexpr int TM3 = MT3 / WM3, TN3 = (NT3 + WN3 - 1) / WN3;
  // the chunk's operands stream through two slots of shared memory, in
  // this order: NQ q/k slices (step 1), NU raw k bands (step 3); the next
  // one is copied (cp.async) while the current one is used, and P (step 2)
  // takes the slot of the last slice
  static constexpr int NQ = HD / DK, NU = HD / DU;
  static constexpr int XQ = 2 * CH * LDQ, XP = CH * LDP, XU = CH * LDU;
  static constexpr int kSlot = XQ > XP ? (XQ > XU ? XQ : XU)
                                       : (XP > XU ? XP : XU);
  // offsets in floats into dynamic shared memory
  static constexpr int kC = 0;                  // C tile [HD][DV], swizzled
  static constexpr int kX = kC + HD * DV;       // two slots
  static constexpr int kV = kX + 2 * kSlot;     // v tile [CH][LDV]
  static constexpr int kA = kV + CH * LDV;      // gates, 7 x [CH]
  static constexpr int kN = kA + 7 * CH;        // n [HD]
  static constexpr int kS = kN + HD;            // m, m_new, decay
  static constexpr int kFloats = kS + 4;
  static_assert((NQ + NU) % 2 == 0, "a chunk's tiles start in slot 0");
  static_assert(CH <= 64, "the gate prologue: two rows per lane of a warp");
  static_assert(CH % 16 == 0 && HD % 16 == 0, "chunk and dh: multiples of 16");
  static_assert(HD % DV == 0 && HD % DK == 0 && HD % DU == 0, "dh tiling");
  static_assert(TM1 <= 2 && WM1 * WN1 == 8, "steps 1-2 warp tiling");
  static_assert(WM3 * WN3 == 8 && MT3 % WM3 == 0, "step 3 warp tiling");
  static_assert(kFloats * 4 <= 232448, "shared memory of one block");
};

// The C tile [HD][DV] is stored unpadded, its columns XOR-swizzled in
// groups of 8 by the row, so that a B fragment (rows t, t + 4, columns g)
// and a D fragment's float2 (rows g, g + 8, columns 2t) hit 32 banks. The
// swizzle depends on the row mod 8 only.
template <int DV>
__device__ __forceinline__ int cswz(int d) {
  return DV >= 32 ? (d & 3) << 3 : ((d >> 1) & 1) << 3;
}

template <int DV>
__device__ __forceinline__ int cidx(int d, int j) {
  return d * DV + (j ^ cswz<DV>(d));
}

// B fragment at rows k0 (a multiple of 8), columns n0 of the C tile
template <int DV>
__device__ __forceinline__ void load_b_c(FragB& f, const float* cs, int k0,
                                         int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* c = cs + (k0 + t) * DV + ((n0 + g) ^ cswz<DV>(t));
  const float x[2] = {c[0], c[4 * DV]};
  split_tf32(x, f.hi, f.lo);
}

// Start copying W columns from column d0 of CH rows from row c0 of x
// ([S][HD] at xb) into dst (row stride ld); rows past s_len read as 0.
template <int CH, int HD, int W>
__device__ __forceinline__ void copy_rows(float* dst, int ld, const float* xb,
                                          int c0, int d0, int s_len,
                                          int tid) {
#pragma unroll
  for (int e = tid; e < CH * W / 4; e += kMlstmThreads) {
    const int t = e / (W / 4), d = 4 * (e - t * (W / 4));
    const bool in = c0 + t < s_len;
    cp_async16(dst + t * ld + d, xb + (int64_t)(in ? c0 + t : 0) * HD + d0 + d,
               in);
  }
}

// A warp's i-th 16-row tile in steps 1-2: wm and MT1 - 1 - wm (TM1 = 2),
// so that the q kT tiles above the diagonal, which it skips, even out.
template <int CH, int HD>
__device__ __forceinline__ int step1_mtile(int wm, int i) {
  using T = MlstmTile<CH, HD>;
  return i == 0 ? wm : T::MT1 - 1 - wm;
}

// Step 1 on one slice of DK head dims: qk += q kT and qc += q C over head
// dims d0 .. d0 + DK, q and k [CH][DK] (row LDQ), C rows d0 .. d0 + DK.
// The tensor core adds each product into its accumulator truncated: over
// 64 steps of 8 at dh 512 a running sum drifts towards zero (3x the plain
// version's error on h). So a slice's products go into zeroed accumulators,
// added to qk and qc in float32, rounded to nearest.
template <int CH, int HD>
__device__ __forceinline__ void qk_qc_slice(
    float (&qk)[MlstmTile<CH, HD>::TM1][MlstmTile<CH, HD>::TK1][4],
    float (&qc)[MlstmTile<CH, HD>::TM1][MlstmTile<CH, HD>::TC1][4],
    const float* qs, const float* ks, const float* cs, int d0, int warp,
    int lane) {
  using T = MlstmTile<CH, HD>;
  constexpr int TM = T::TM1, TK = T::TK1, TC = T::TC1, WN = T::WN1;
  const int wm = warp % T::WM1, wn = warp / T::WM1;
  float sk[TM][TK][4], sc[TM][TC][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int j = 0; j < TK; ++j) sk[i][j][e] = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) sc[i][j][e] = 0.f;
    }
#pragma unroll
  for (int k0 = 0; k0 < T::DK; k0 += 8) {
    FragA a[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      load_a(a[i], qs, T::LDQ, step1_mtile<CH, HD>(wm, i) * 16, k0, lane);
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      const int nt = wn + j * WN;
      if (T::NK1 % WN != 0 && nt >= T::NK1) continue;
      FragB b;
      load_bt(b, ks, T::LDQ, k0, nt * 8, lane);
#pragma unroll
      for (int i = 0; i < TM; ++i)  // tiles wholly above the diagonal: 0
        mma3(sk[i][j], a[i], b, nt * 8 < step1_mtile<CH, HD>(wm, i) * 16 + 16);
    }
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int nt = wn + j * WN;
      if (T::NC1 % WN != 0 && nt >= T::NC1) continue;
      FragB b;
      load_b_c<T::DV>(b, cs, d0 + k0, nt * 8, lane);
#pragma unroll
      for (int i = 0; i < TM; ++i) mma3(sc[i][j], a[i], b);
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int j = 0; j < TK; ++j) qk[i][j][e] += sk[i][j][e];
#pragma unroll
      for (int j = 0; j < TC; ++j) qc[i][j][e] += sc[i][j][e];
    }
}

// Step 2's P v: qc (already e_inter q C) += P [CH][CH] (row LDP) v [CH][DV]
// (row LDV). P is 0 right of the diagonal: a 16-row tile stops at its last
// row's key.
template <int CH, int HD>
__device__ __forceinline__ void pv_product(
    float (&qc)[MlstmTile<CH, HD>::TM1][MlstmTile<CH, HD>::TC1][4],
    const float* ps, const float* vs, int warp, int lane) {
  using T = MlstmTile<CH, HD>;
  constexpr int TM = T::TM1, WN = T::WN1;
  const int wm = warp % T::WM1, wn = warp / T::WM1;
#pragma unroll
  for (int k0 = 0; k0 < CH; k0 += 8) {
    FragA a[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      load_a(a[i], ps, T::LDP, step1_mtile<CH, HD>(wm, i) * 16, k0, lane);
#pragma unroll
    for (int j = 0; j < T::TC1; ++j) {
      const int nt = wn + j * WN;
      if (T::NC1 % WN != 0 && nt >= T::NC1) continue;
      FragB b;
      load_b(b, vs, T::LDV, k0, nt * 8, lane);
#pragma unroll
      for (int i = 0; i < TM; ++i)
        mma3(qc[i][j], a[i], b, k0 < step1_mtile<CH, HD>(wm, i) * 16 + 16);
    }
  }
}

// Step 3 on one band of C: rows u0 .. u0 + DU of the [HD][DV] tile become
// decay C + kw^T v, kw [CH][DU] (row LDU) and v [CH][DV] (row LDV).
template <int CH, int HD>
__device__ __forceinline__ void update_c_band(float* cs, const float* kw,
                                              const float* vs, int u0,
                                              float decay, int warp,
                                              int lane) {
  using T = MlstmTile<CH, HD>;
  constexpr int DV = T::DV, TM = T::TM3, TN = T::TN3, WN = T::WN3;
  const int wm = warp % T::WM3, wn = warp / T::WM3;
  if (T::NT3 < WN && wn >= T::NT3) return;  // no tile for this warp
  const int g = lane >> 2, t = lane & 3, sw = cswz<DV>(g);
  float acc[TM][TN][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int nt = wn + j * WN;
      if (T::NT3 % WN != 0 && nt >= T::NT3) continue;
      float* c = cs + (u0 + (wm * TM + i) * 16 + g) * DV +
                 ((nt * 8 + 2 * t) ^ sw);
      const float2 lo = *reinterpret_cast<const float2*>(c);
      const float2 hi = *reinterpret_cast<const float2*>(c + 8 * DV);
      acc[i][j][0] = decay * lo.x; acc[i][j][1] = decay * lo.y;
      acc[i][j][2] = decay * hi.x; acc[i][j][3] = decay * hi.y;
    }
#pragma unroll
  for (int k0 = 0; k0 < CH; k0 += 8) {
    FragA a[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      load_at(a[i], kw, T::LDU, (wm * TM + i) * 16, k0, lane);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int nt = wn + j * WN;
      if (T::NT3 % WN != 0 && nt >= T::NT3) continue;
      FragB b;
      load_b(b, vs, T::LDV, k0, nt * 8, lane);
#pragma unroll
      for (int i = 0; i < TM; ++i) mma3(acc[i][j], a[i], b);
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int nt = wn + j * WN;
      if (T::NT3 % WN != 0 && nt >= T::NT3) continue;
      float* c = cs + (u0 + (wm * TM + i) * 16 + g) * DV +
                 ((nt * 8 + 2 * t) ^ sw);
      *reinterpret_cast<float2*>(c) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(c + 8 * DV) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

template <int CH, int HD>
__global__ void __launch_bounds__(kMlstmThreads) mlstm_scan_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ log_i,
    const float* __restrict__ log_f, float* __restrict__ h,
    float* __restrict__ c_out, float* __restrict__ n_out,
    float* __restrict__ m_out, int s_len) {
  using T = MlstmTile<CH, HD>;
  constexpr int DV = T::DV, DK = T::DK, DU = T::DU, NQ = T::NQ, NU = T::NU;
  constexpr int LDQ = T::LDQ, LDP = T::LDP, LDV = T::LDV, LDU = T::LDU;
  constexpr int R = kMlstmThreads / CH;  // threads per row (q . n, den)
  extern __shared__ __align__(16) float smem[];
  float* cs = smem + T::kC;
  float* slots = smem + T::kX;     // slot i: smem + kX + i kSlot
  float* ps = slots + ((NQ - 1) & 1) * T::kSlot;  // P [CH][LDP]
  float* vs = smem + T::kV;
  float* a_s = smem + T::kA;       // log_f, then its cumsum A
  float* li_s = a_s + CH;          // log_i
  float* mloc = li_s + CH;         // row stabiliser m_loc
  float* einter = mloc + CH;       // exp(A + m - m_loc)
  float* gk = einter + CH;         // exp(w_end - m_new) / sqrt(dh)
  float* qn = gk + CH;             // q . n
  float* den = qn + CH;            // denominator
  float* nv = smem + T::kN;        // n [HD]
  float* sc = smem + T::kS;        // m, m_new, decay

  const int bh = blockIdx.x, j0 = blockIdx.y * DV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp % T::WM1, wn = warp / T::WM1;  // steps 1-2 warp tile
  const float scale = 1.0f / sqrtf((float)HD);
  const int64_t xbase = (int64_t)bh * s_len * HD;
  const int64_t gbase = (int64_t)bh * s_len;
  const float *qb = q + xbase, *kb = k + xbase, *vb = v + xbase;

  // the gates and q/k slice 0 of the chunk from row c0 into slot 0
  auto copy_chunk_head = [&](int c0) {
    if (tid < CH) {
      const bool in = c0 + tid < s_len;
      const int64_t r = gbase + (in ? c0 + tid : 0);
      cp_async4(li_s + tid, log_i + r, in);
      cp_async4(a_s + tid, log_f + r, in);
    }
    copy_rows<CH, HD, DK>(slots, LDQ, qb, c0, 0, s_len, tid);
    copy_rows<CH, HD, DK>(slots + CH * LDQ, LDQ, kb, c0, 0, s_len, tid);
  };

  for (int e = tid; e < HD * DV; e += kMlstmThreads) cs[e] = 0.f;
  for (int e = tid; e < HD; e += kMlstmThreads) nv[e] = 0.f;
  if (tid == 0) sc[0] = kMlstmNegInf;
  if (s_len > 0) copy_chunk_head(0);  // S = 0: no row to read
  cp_async_commit();

  for (int c0 = 0; c0 < s_len; c0 += CH) {
    // ---- 0. the gates (warp 0): A = cumsum log_f (one lane, in the plain
    // version's order), the row stabiliser m_loc = max(A_t + m, A_t +
    // max_{s<=t} (li_s - A_s)) (a shuffle scan: max does not round), the
    // end-of-chunk m_new and decay, the key weights exp(A_T - A_s + li_s -
    // m_new) --------------------------------------------------------------
    cp_async_wait<0>();
    __syncthreads();
    if (warp == 0) {
      if (lane == 0) {
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < CH; t += 4) {
          float4 x = *reinterpret_cast<float4*>(a_s + t);
          x.x = acc += x.x;
          x.y = acc += x.y;
          x.z = acc += x.z;
          x.w = acc += x.w;
          *reinterpret_cast<float4*>(a_s + t) = x;
        }
      }
      __syncwarp();
      const float m_prev = sc[0];
      float f[2], l[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = lane + 32 * u;
        const bool row = r < CH, in = row && c0 + r < s_len;
        f[u] = row ? a_s[r] : 0.f;
        l[u] = in ? li_s[r] : kMlstmNegInf;
      }
      float p[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) p[u] = l[u] - f[u];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float y = __shfl_up_sync(0xffffffffu, p[u], o);
          if (lane >= o) p[u] = fmaxf(p[u], y);
        }
      p[1] = fmaxf(p[1], __shfl_sync(0xffffffffu, p[0], 31));
      const float a_end = a_s[CH - 1];
      const float p_end =
          __shfl_sync(0xffffffffu, p[(CH - 1) / 32], (CH - 1) & 31);
      const float m_new = fmaxf(a_end + m_prev, a_end + p_end);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = lane + 32 * u;
        if (r >= CH) continue;
        const float binter = f[u] + m_prev;
        const float ml = fmaxf(binter, f[u] + p[u]);
        li_s[r] = l[u];
        mloc[r] = ml;
        einter[r] = expf(binter - ml);
        gk[r] = expf(a_end - f[u] + l[u] - m_new) * scale;
      }
      if (lane == 0) {
        sc[1] = m_new;
        sc[2] = expf(a_end + m_prev - m_new);
      }
    }
    __syncthreads();

    // ---- 1. q kT, q C (the block's columns) and q . n, a slice at a time:
    // slice i in slot i & 1 while the next tile is copied into the other --
    float qk[T::TM1][T::TK1][4], qc[T::TM1][T::TC1][4];
#pragma unroll
    for (int i = 0; i < T::TM1; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int j = 0; j < T::TK1; ++j) qk[i][j][e] = 0.f;
#pragma unroll
        for (int j = 0; j < T::TC1; ++j) qc[i][j][e] = 0.f;
      }
    float qn_part = 0.f;
    for (int i = 0; i < NQ; ++i) {
      float* nxt = slots + ((i + 1) & 1) * T::kSlot;
      if (i + 1 < NQ) {
        copy_rows<CH, HD, DK>(nxt, LDQ, qb, c0, (i + 1) * DK, s_len, tid);
        copy_rows<CH, HD, DK>(nxt + CH * LDQ, LDQ, kb, c0, (i + 1) * DK,
                              s_len, tid);
      } else {
        copy_rows<CH, HD, DU>(nxt, LDU, kb, c0, 0, s_len, tid);  // band 0
      }
      if (i == 0) copy_rows<CH, HD, DV>(vs, LDV, vb, c0, j0, s_len, tid);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // slice i is in
      const float* qs = slots + (i & 1) * T::kSlot;
      qk_qc_slice<CH, HD>(qk, qc, qs, qs + CH * LDQ, cs, i * DK, warp, lane);
      const int r = tid / R;
#pragma unroll 4
      for (int d = tid % R; d < DK; d += R)
        qn_part = fmaf(qs[r * LDQ + d], nv[i * DK + d], qn_part);
      __syncthreads();  // slot i & 1 is read
    }
#pragma unroll
    for (int o = R / 2; o > 0; o >>= 1)
      qn_part += __shfl_xor_sync(0xffffffffu, qn_part, o);
    if (tid % R == 0) qn[tid / R] = qn_part;

    // ---- 2. h = ((S o qk) v + e_inter q C) / max(|den|, exp(-m_loc)) --
    // P[t][s] = exp(W - m_loc) qk / sqrt(dh), W = A_t - A_s + li_s for
    // s <= t, else -1e30, from step 1's q kT tiles; its q C tiles, times
    // e_inter, are the accumulators of P v
    if (NQ == 1) cp_async_wait<0>();  // v came with band 0
#pragma unroll
    for (int i = 0; i < T::TM1; ++i) {
      const int r0 = step1_mtile<CH, HD>(wm, i) * 16 + g;
#pragma unroll
      for (int j = 0; j < T::TK1; ++j) {
        const int nt = wn + j * T::WN1;
        if (T::NK1 % T::WN1 != 0 && nt >= T::NK1) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = r0 + (e >= 2 ? 8 : 0), s = nt * 8 + 2 * tq + (e & 1);
          const float w = s <= t ? a_s[t] - a_s[s] + li_s[s] : kMlstmNegInf;
          ps[t * LDP + s] = expf(w - mloc[t]) * (qk[i][j][e] * scale);
        }
      }
#pragma unroll
      for (int j = 0; j < T::TC1; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          qc[i][j][e] *= einter[r0 + (e >= 2 ? 8 : 0)];
    }
    __syncthreads();  // P, q . n and v
    {
      const int r = tid / R;
      float rowsum = 0.f;
      for (int s = tid % R; s < CH; s += R) rowsum += ps[r * LDP + s];
#pragma unroll
      for (int o = R / 2; o > 0; o >>= 1)
        rowsum += __shfl_xor_sync(0xffffffffu, rowsum, o);
      if (tid % R == 0) den[r] = rowsum + einter[r] * qn[r];
    }
    pv_product<CH, HD>(qc, ps, vs, warp, lane);
    __syncthreads();  // den; P and v are read
#pragma unroll
    for (int i = 0; i < T::TM1; ++i)
#pragma unroll
      for (int j = 0; j < T::TC1; ++j) {
        const int nt = wn + j * T::WN1;
        if (T::NC1 % T::WN1 != 0 && nt >= T::NC1) continue;
        const int r0 = step1_mtile<CH, HD>(wm, i) * 16 + g;
        const int col = j0 + nt * 8 + 2 * tq;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = r0 + 8 * half;
          if (c0 + t >= s_len) continue;
          const float dn = fmaxf(fabsf(den[t]), expf(-mloc[t]));
          *reinterpret_cast<float2*>(h + xbase + (int64_t)(c0 + t) * HD +
                                     col) =
              make_float2(qc[i][j][2 * half] / dn,
                          qc[i][j][2 * half + 1] / dn);
        }
      }
    // step 3 takes v weighted by the key weights: (k w)T v = kT (w v)
    for (int e = tid; e < CH * DV; e += kMlstmThreads) {
      const int s = e / DV, j = e - s * DV;
      vs[s * LDV + j] *= gk[s];
    }

    // ---- 3. C = decay C + kT (w v), n = decay n + sum_s k w, in bands
    // of DU rows of C: band b in slot (NQ + b) & 1, the raw k [CH][DU] ----
    const float decay = sc[2];
    for (int b = 0; b < NU; ++b) {
      float* nxt = slots + ((NQ + b + 1) & 1) * T::kSlot;
      if (b + 1 < NU)
        copy_rows<CH, HD, DU>(nxt, LDU, kb, c0, (b + 1) * DU, s_len, tid);
      else if (c0 + CH < s_len)  // the next chunk's head, into slot 0
        copy_chunk_head(c0 + CH);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // band b is in (and w v is written)
      const float* kr = slots + ((NQ + b) & 1) * T::kSlot;
      const int u0 = b * DU;
      if (tid < DU) {  // 8 partial sums: no 64-long chain of dependent FMAs
        float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < CH; ++s)
          sum[s & 7] = fmaf(kr[s * LDU + tid], gk[s], sum[s & 7]);
        nv[u0 + tid] = decay * nv[u0 + tid] +
                       (((sum[0] + sum[1]) + (sum[2] + sum[3])) +
                        ((sum[4] + sum[5]) + (sum[6] + sum[7])));
      }
      update_c_band<CH, HD>(cs, kr, vs, u0, decay, warp, lane);
      __syncthreads();  // slot (NQ + b) & 1 is read
    }
    if (tid == 0) sc[0] = sc[1];
  }

  __syncthreads();
  float* cdst = c_out + (int64_t)bh * HD * HD + j0;
  for (int e = tid; e < HD * DV; e += kMlstmThreads) {
    const int d = e / DV, j = e - d * DV;
    cdst[(int64_t)d * HD + j] = cs[cidx<DV>(d, j)];
  }
  if (blockIdx.y == 0) {
    for (int e = tid; e < HD; e += kMlstmThreads)
      n_out[(int64_t)bh * HD + e] = nv[e];
    if (tid == 0) m_out[bh] = sc[0];
  }
}

template <int CH, int HD>
int launch_mlstm(const float* q, const float* k, const float* v,
                 const float* li, const float* lf, float* h, float* c,
                 float* n, float* m, int bh, int s_len, cudaStream_t stream) {
  using T = MlstmTile<CH, HD>;
  constexpr size_t smem = sizeof(float) * T::kFloats;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mlstm_scan_kernel<CH, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(bh, HD / T::DV);
  mlstm_scan_kernel<CH, HD><<<grid, kMlstmThreads, smem, stream>>>(
      q, k, v, li, lf, h, c, n, m, s_len);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_mlstm_chunk(int chunk, const float* q, const float* k,
                       const float* v, const float* li, const float* lf,
                       float* h, float* c, float* n, float* m, int bh,
                       int s_len, cudaStream_t st) {
  switch (chunk) {
    case 16:
      return launch_mlstm<16, HD>(q, k, v, li, lf, h, c, n, m, bh, s_len, st);
    case 32:
      return launch_mlstm<32, HD>(q, k, v, li, lf, h, c, n, m, bh, s_len, st);
    case 64:
      return launch_mlstm<64, HD>(q, k, v, li, lf, h, c, n, m, bh, s_len, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace libra

extern "C" int libra_mlstm_scan(const void* q, const void* k, const void* v,
                                const void* log_i, const void* log_f,
                                void* h, void* c, void* n, void* m, int bh,
                                int s_len, int hd, int chunk,
                                void* cuda_stream) {
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  const float* lif = (const float*)log_i;
  const float* lff = (const float*)log_f;
  float* hf = (float*)h;
  float* cf = (float*)c;
  float* nf = (float*)n;
  float* mf = (float*)m;
  cudaStream_t st = (cudaStream_t)cuda_stream;
  switch (hd) {
    case 16:
      return libra::launch_mlstm_chunk<16>(chunk, qf, kf, vf, lif, lff, hf,
                                           cf, nf, mf, bh, s_len, st);
    case 32:
      return libra::launch_mlstm_chunk<32>(chunk, qf, kf, vf, lif, lff, hf,
                                           cf, nf, mf, bh, s_len, st);
    case 64:
      return libra::launch_mlstm_chunk<64>(chunk, qf, kf, vf, lif, lff, hf,
                                           cf, nf, mf, bh, s_len, st);
    case 512:
      return libra::launch_mlstm_chunk<512>(chunk, qf, kf, vf, lif, lff, hf,
                                            cf, nf, mf, bh, s_len, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
