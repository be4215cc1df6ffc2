// Shared pieces of the four batched-datapath kernels (sm_90a).
//
// Conventions for every kernel in this directory:
//   * all data is int32; every offset into a 2-D tensor is computed in
//     64 bits ((int64_t)row * width + col), so a [32769, 1024] pool or a
//     [B, S] stream never overflows an int index;
//   * a kernel launches on the caller's stream, allocates nothing and does
//     not synchronise; its C entry point returns cudaGetLastError() so the
//     Python wrapper can raise on a refused launch;
//   * optional operands arrive as null pointers.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <initializer_list>

namespace libra {

constexpr int kPad = -1;          // padding condition slot (always holds)
constexpr int kPayloadBase = -2;  // off <= -2: payload position -off - 2
constexpr unsigned kFullMask = 0xffffffffu;

// Threads for a block that walks one page of `page` lanes: a multiple of
// 32, at most 256. Lanes are strided by blockDim.x, so each warp touches
// 32 neighbouring tokens per access (coalesced whatever the alignment).
inline int page_threads(int page) {
  int t = ((page + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 256 ? 256 : t);
}

// Compact row b's metadata prefix: meta[b, i] = stream[b, min(i, S - 1)]
// for i < meta_len[b], else 0. Run by every thread of one block. The row
// is loaded whatever mlen is, so the loads need not wait for it.
__device__ __forceinline__ void meta_row(const int* __restrict__ stream,
                                         int mlen, int* __restrict__ meta,
                                         int b, int s, int meta_max) {
  const int64_t row = (int64_t)b * s;
  for (int i = threadIdx.x; i < meta_max; i += blockDim.x) {
    const int v = __ldg(stream + row + (i < s ? i : s - 1));
    meta[(int64_t)b * meta_max + i] = i < mlen ? v : 0;
  }
}

// One policy condition against one message. `meta_at(off)` returns the
// (decrypted) metadata token at 0 <= off < min(mlen, M); `pay_at(pos)`
// returns the plaintext first-page window token at 0 <= pos < min(plen, W).
template <class MetaAt, class PayAt>
__device__ __forceinline__ bool cond_holds(int off, int lo, int hi, int mlen,
                                           int m, long long plen, int w,
                                           bool has_payload, MetaAt meta_at,
                                           PayAt pay_at) {
  if (off == kPad) return true;
  if (off >= 0) {
    if (off >= mlen || off >= m) return false;
    const int v = meta_at(off);
    return v >= lo && v <= hi;
  }
  if (!has_payload) return false;
  const long long pos = kPayloadBase - (long long)off;  // no INT_MIN overflow
  if (pos >= plen || pos >= w) return false;
  const int v = pay_at((int)pos);
  return v >= lo && v <= hi;
}

// First matching rule of a dense [R, K] condition table for ONE message,
// evaluated by one whole warp: lanes take rules lane, lane + 32, ...; each
// chunk of 32 rules is reduced with __reduce_min_sync over
// (rule_ok ? r : R), and the scan stops at the first chunk with a match.
// Every lane of the warp must call it; all lanes return the same value.
// Returns R when no rule matches (and for R == 0).
template <class MetaAt, class PayAt>
__device__ __forceinline__ int first_match_warp(
    const int* __restrict__ off, const int* __restrict__ lo,
    const int* __restrict__ hi, const int* __restrict__ live, int r, int k,
    int mlen, int m, long long plen, int w, bool has_payload, MetaAt meta_at,
    PayAt pay_at) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < r; base += 32) {
    const int rule = base + lane;
    bool ok = rule < r;
    if (ok && live != nullptr) ok = live[rule] > 0;
    for (int c = 0; ok && c < k; ++c) {
      const int64_t i = (int64_t)rule * k + c;
      ok = cond_holds(off[i], lo[i], hi[i], mlen, m, plen, w, has_payload,
                      meta_at, pay_at);
    }
    const int best = __reduce_min_sync(kFullMask, ok ? rule : r);
    if (best < r) return best;
  }
  return r;
}

// ---------------------------------------------------------------------------
// The page-tile ring of fused_round. (selective_gather was measured on it
// too and keeps its one-page-a-block kernel, which was faster at the
// deployment's one task a block: PERF.md, section 6.)
//
// A launch's work is a list of tasks, numbered row by row; a task is one
// tile of at most kTile tokens of one page of one row (fused_round adds
// one metadata-and-verdict task a row, first in the row). The launch runs
// as many blocks as fit on the card at once, at most one a task, and block
// k walks a contiguous range of about T / G of the T tasks, so the grid
// is one wave at any shape. Each block holds a ring of `depth`
// slots in dynamic shared memory: the copies of task i of its range go
// into slot i % depth, issued depth - 1 tasks before task i is computed,
// the counterpart of the Pallas kernel's `_prefetch_ahead` and `_wait`.
// A task's parameters (its table entry and lengths, a 32-byte record the
// kernel fills) are read from global memory by a lane of warp 0, 32 tasks
// before its copies go out (the first ones at the block's start, in
// parallel), so the table -> page round trip is paid once a block, not
// once a task.
//
// Two copy paths; the shapes and pointers decide, per launch:
//   * kBulk: one thread issues a TMA 1-D bulk copy a window
//     (cp.async.bulk ... mbarrier::complete_tx) of 16-byte-aligned
//     covers, and the slot's mbarrier counts the bytes;
//   * otherwise every thread issues 4-byte cp.async for its share of each
//     window and arrives on the slot's mbarrier when its copies land
//     (cp.async.mbarrier.arrive.noinc), the barrier counting all threads.
// A slot is refilled only after a __syncthreads() that follows the last
// read of its previous task: one block barrier a task.
// ---------------------------------------------------------------------------

constexpr int kTile = 1024;        // tokens of a tile: 4 KB
constexpr int kRingThreads = 128;  // threads of a ring block
static_assert(kTile % (4 * kRingThreads) == 0, "whole int4 groups a thread");

__host__ __device__ inline int up4(int n) { return (n + 3) & ~3; }

// Tokens [lo, hi) of a row to copy into a slot: the slot's word 0 holds
// token `base`, and `words` tokens are copied. The bulk path copies the
// 16-byte-aligned cover; the caller guarantees the cover stays inside the
// row (its width is a multiple of 4 there).
struct Window {
  long long base;
  int words;
};

__host__ __device__ inline Window window(long long lo, long long hi,
                                        bool bulk) {
  if (hi <= lo) return {lo, 0};
  const long long base = bulk ? (lo & ~3LL) : lo;
  const long long end = bulk ? ((hi + 3) & ~3LL) : hi;
  return {base, (int)(end - base)};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// TMA 1-D bulk copy of `words` int32 (16-byte-aligned ends) into this
// block's shared memory, completing `bytes` on `bar`.
__device__ __forceinline__ void bulk_copy(int* dst, const int* src,
                                          int words, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(words * 4), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void copy4(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// A task as the ring carries it: decoded, with its table entry and
// lengths read. The fields are the kernel's (32 bytes).
struct Task {
  int b, page_slot, lo, n;  // row, table slot (-1: the metadata task), tile
  int pid, mlen, len, base;  // table entry, lengths, slot word 0's token
};

// The ring's bookkeeping in dynamic shared memory, after the slots:
// [slots: depth x slot_words int][hdr: depth Task][staged: 2 Task]
// [bars: depth uint64] -- then whatever the kernel adds (8-byte aligned).
struct Ring {
  int* slots;
  Task* hdr;     // the task each slot holds
  Task* staged;  // the next task to issue, by its parity
  uint64_t* bars;
  int depth;
  int slot_words;
};

__host__ __device__ inline size_t ring_bytes(int depth, int slot_words) {
  return (size_t)depth * (4 * (size_t)slot_words + sizeof(Task) + 8) +
         2 * sizeof(Task);
}

__device__ __forceinline__ Ring ring_at(int* smem, int depth,
                                        int slot_words) {
  Ring g;
  g.slots = smem;
  g.hdr = reinterpret_cast<Task*>(smem + (size_t)depth * slot_words);
  g.staged = g.hdr + depth;
  g.bars = reinterpret_cast<uint64_t*>(g.staged + 2);
  g.depth = depth;
  g.slot_words = slot_words;
  return g;
}

// This block's range [t0, t1) of the launch's tasks: launch_ring gives
// each block `per` tasks and the first `extra` blocks one more. Every
// thread computes it, so it takes no division.
__device__ __forceinline__ void block_range(int per, int extra, int* t0,
                                            int* t1) {
  const int k = blockIdx.x;
  *t0 = k * per + (k < extra ? k : extra);
  *t1 = *t0 + per + (k < extra);
}

// Walk tasks [t0, t1) through the ring. Called by every thread of the
// block.
//   load(t) -> Task        decodes task t and reads its table entry and
//                          lengths from global memory (one thread);
//   plan(task, visit)      calls visit(slot_offset, src, words) for each
//                          window of the task;
//   prologue()             work that overlaps the first tasks' loads (its
//                          shared-memory writes are visible to every
//                          task);
//   consume(task, slot, wait)
//                          computes the task from its slot; it calls
//                          wait() once, after issuing its own loads that
//                          do not depend on the slot.
template <bool kBulk, class Load, class Plan, class Prologue, class Consume>
__device__ __forceinline__ void ring_walk(const Ring& g, int t0, int t1,
                                          Load load, Plan plan,
                                          Prologue prologue,
                                          Consume consume) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool warp0 = tid < 32;
  const int depth = g.depth;
  const int n = t1 - t0;
  if (tid == 0) {
    for (int s = 0; s < depth; ++s)
      bar_init(&g.bars[s], kBulk ? 1 : blockDim.x);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Tasks 0 .. depth - 2 go straight into their slots' records, one
  // thread each. Lane j of warp 0 holds task depth - 1 + j and, once it has
  // handed it on, the task 32 further: a task's parameters are read 32
  // tasks before its copies go out.
  Task first, mine;
  if (tid < depth - 1 && tid < n) first = load(t0 + tid);
  if (warp0 && depth - 1 + lane < n) mine = load(t0 + depth - 1 + lane);
  prologue();
  if (tid < depth - 1 && tid < n) g.hdr[tid] = first;
  // warp 0: task i + depth - 1, held by lane i % 32, into staged[] for
  // iteration i (it must run between iteration i - 1's reads and the
  // barrier that starts iteration i)
  auto stage = [&](int i) {
    const int u = i + depth - 1;
    if (u >= n) return;
    const int src = i & 31;
    Task k;
    k.b = __shfl_sync(kFullMask, mine.b, src);
    k.page_slot = __shfl_sync(kFullMask, mine.page_slot, src);
    k.lo = __shfl_sync(kFullMask, mine.lo, src);
    k.n = __shfl_sync(kFullMask, mine.n, src);
    k.pid = __shfl_sync(kFullMask, mine.pid, src);
    k.mlen = __shfl_sync(kFullMask, mine.mlen, src);
    k.len = __shfl_sync(kFullMask, mine.len, src);
    k.base = __shfl_sync(kFullMask, mine.base, src);
    if (lane == 0) g.staged[u & 1] = k;
    if (lane == src && u + 32 < n) mine = load(t0 + u + 32);
  };
  if (warp0) stage(0);
  __syncthreads();

  auto issue = [&](int i, const Task& k) {  // task t0 + i -> slot i % depth
    const int s = i % depth;
    int* dst = g.slots + s * g.slot_words;
    uint64_t* bar = &g.bars[s];
    if (kBulk) {
      int words = 0;
      plan(k, [&](int, const int*, int w) { words += w; });
      bar_expect_tx(bar, 4 * words);
      plan(k, [&](int off, const int* src, int w) {
        bulk_copy(dst + off, src, w, bar);
      });
    } else {
      plan(k, [&](int off, const int* src, int w) {
        for (int q = tid; q < w; q += blockDim.x)
          copy4(dst + off + q, src + q);
      });
      copy4_arrive(bar);
    }
  };
  // the bulk path's copies are one thread's work; the others skip them
  const bool issuer = !kBulk || tid == 0;
  if (issuer)
    for (int i = 0; i < depth - 1 && i < n; ++i) issue(i, g.hdr[i]);

  int s = 0, phase = 0;  // slot and barrier phase of task i
  for (int i = 0; i < n; ++i) {
    if (i > 0) __syncthreads();  // task i - 1 is read: its slot may refill
    const int u = i + depth - 1;
    if (issuer && u < n) {
      const Task k = g.staged[u & 1];
      if (tid == 0) g.hdr[u % depth] = k;
      issue(u, k);
    }
    uint64_t* bar = &g.bars[s];
    const uint32_t parity = phase;
    consume(g.hdr[s], g.slots + s * g.slot_words,
            [&] { bar_wait(bar, parity); });
    if (warp0) stage(i + 1);
    if (++s == depth) {
      s = 0;
      phase ^= 1;
    }
  }
}

// Launch a ring kernel of kRingThreads-thread blocks with `smem` bytes of
// dynamic shared memory: as many blocks as fit on the card at once, at
// most `tasks`, each given args.per tasks and the first args.extra one
// more. The attribute is set at every launch (a static cache here would
// be one symbol across every library a process loads).
template <class Kernel, class Args>
inline int launch_ring(Kernel kernel, Args args, long long tasks,
                       size_t smem, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kRingThreads, smem);
  if (e == cudaSuccess && (per_sm < 1 || tasks > 0x7fffffffLL))
    e = cudaErrorInvalidConfiguration;
  if (e != cudaSuccess) {
    cudaGetLastError();  // not left behind for a later launch to report
    return (int)e;
  }
  const long long fit = (long long)per_sm * sms;
  const int blocks = (int)(tasks < fit ? tasks : fit);
  args.per = (int)(tasks / blocks);
  args.extra = (int)(tasks % blocks);
  kernel<<<blocks, kRingThreads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

// Every pointer is 16-byte aligned (null counts as aligned).
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15) return false;
  return true;
}

}  // namespace libra
