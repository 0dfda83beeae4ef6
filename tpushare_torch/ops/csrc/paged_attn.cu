// K2's prefill arm: the paged-pool read at S > 1 for Hopper (sm_90a).
//
// Replaces tpushare/ops/attention.py::_paged_attn_kernel (the Pallas TPU
// kernel launched by paged_decode_attention) for every call with S > 1 (a
// prefill window, a chunk of the windowed ring): the bf16 store and the
// int8 store (quantized=True, the body's :664-692), each also in its
// striped variant (with_pos_map + with_stats, :662, :699, :722-724).
// Reads one layer's pool [n_pages, Hkv, page, D] through page_table [B,
// n_tbl] (int32, logical page order, 0-padded: page 0 is the trash page)
// for queries q [B, H, S, D] at positions [B, S], and writes out [B, H,
// S, D].  A key's position is (pos_map ? pos_map[j] : j * page) + lane for
// table entry j; the mask keeps key <= position (and > position -
// window).  S = 1 goes to paged_decode.cu.
//
// Bound on an H100: operations.  A 2000-token window does ~33 GFLOP over
// its causal pairs against ~8 MB of K/V, K1's work at S = 2048, so the
// design is K1's (flash_fwd.cu, on sm90.cuh) with the keys read through
// the page table:
//
// * The n_rep q heads of kv head kh are one contiguous slab of q and of
//   out, [n_rep * S, D] (row r: head kh * n_rep + r / S at position
//   r % S), so each K/V page is read once per kv head, never expanded.  A
//   block owns 128 of those rows of one (b, kh): Q arrives by one TMA
//   load of q viewed as [B * Hkv, n_rep * S, D] (rows past the slab read
//   as zeros) and out leaves by the clipped TMA store.
// * Three warpgroups: a producer and two consumers of 64 rows.  Each
//   consumer walks the key range of its own rows (from their positions
//   and the window: up to the last entry any of them sees, from the first
//   the window reaches), so a tile that crosses a q head widens only one
//   consumer's walk; the block's producer loads the union.  A consumer
//   only waits for and releases the tiles outside its range.  A consumer
//   whose rows see no key writes out 0 (striped: m NEG_INF, l 0).
// * The producer warpgroup copies 128-key K and V tiles, K one tile ahead
//   of V, by cp.async: 16-byte chunks through the page table (each thread
//   reads its key's entry from global memory a K tile ahead) into the
//   128-byte-swizzled layout wgmma's descriptors read, keys past the walk
//   zero-filled; any page size and any table width.  After its copies
//   land, each thread fences them for the async proxy (fence.proxy.async:
//   wgmma reads shared memory through it and could see stale bytes
//   without it) and arrives on the stage's full barrier.  The int8
//   store's raw rows and scales (four a 16-byte chunk, so page % 4 == 0)
//   go into one of two raw slots while the producer dequantizes the
//   previous tile into the stage, each element bf16(f32(q) * s) as the
//   TPU body rounds it.
// * The consumers run S = Q K^T as wgmma m64n128k16 SS and O += P V as
//   RS with P from the S accumulator rounded to bf16 and V read
//   transposed; tile j's S is issued before tile j - 1's P V, so the
//   softmax overlaps the tensor cores.  Only diagonal, window-edge and
//   ragged tiles are masked; a tile every row of the consumer keeps whole
//   is folded unmasked.
// * Blocks run band by band (each q head's last 128 positions first, the
//   heaviest causal rows), and within a band the n_rep heads of one kv
//   head side by side, so their K/V tiles come from L2.
//
// Numerics are K1's and the TPU kernel's: f32 scaled scores (base 2
// inside), the finite NEG_INF mask, p multiplied by the keep mask (a
// fully masked tile cannot poison the carry, :710-711), P rounded to bf16
// before PV while l sums the f32 p, l clamped to 1e-30.
//
// The striped variant (kStriped) reads one position stripe's local table:
// a consumer's walk ends after the entries that start at or before its
// last position and starts at the first its window reaches (counts:
// pos_map increases), and the producer reads each key's pos_map entry with
// its table entry and writes each K tile's key positions to shared memory
// for the mask.  It writes each row's softmax partials m (base e) and l
// (unclamped) for the cross-stripe merge (sp_merge_partials).
#include <climits>
#include <type_traits>

#include "paged_pool.cuh"
#include "sm90.cuh"

namespace tpushare {

// what a launch takes besides the pool
struct Args {
  const void* q;
  const void* table;
  const void* pos_map;  // kStriped only
  const void* positions;
  void* o;
  void* m;  // kStriped only
  void* l;  // kStriped only
  int B, H, Hkv, S, D, page, n_tbl, window;
  float scale;
};

namespace prefill {

constexpr int kTile = 128;                  // rows a block, keys a tile
constexpr int kHalfBytes = kTile * 64 * 2;  // one 64-column bf16 half
constexpr int kBlockThreads = 3 * 128;      // producer + two consumers
constexpr int kConsumerWarps = 8;
constexpr int kProducerBar = 3;  // named barrier of the producer warpgroup
// setmaxnreg: the producer's copies and int8 dequantization need more
// than the 24 registers a TMA-only producer keeps (at 24 they spill; at
// 40 the int8 loads run slower).  The launch gives each of the 384
// threads 168 registers, and the consumers' setmaxnreg.inc takes only
// what the producer's .dec gave back (asked for more, it waits for
// ever): 128 * (168 - P) >= 256 * (C - 168)
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
static_assert(kProducerRegs + 2 * kConsumerRegs <= 3 * 168,
              "the consumers' setmaxnreg.inc would wait for ever");
// the producer's rows of a tile in flight, tile i in slot i % 3 (see
// Producer::issue)
constexpr int kSlotRing = 3;

// one int8 tile in flight: raw K or V rows of 128 keys and their scales
template <int D>
struct RawSlot {
  int8_t v[kTile][D];
  float s[kTile];
};
template <int D>
struct RawRing {
  RawSlot<D> slot[2];
};
struct NoRaw {};

template <int D, bool kInt8>
struct Smem {
  static constexpr int kHalves = D / 64;
  // D = 128: Q and two stages of K and V, 160 KB (as K1); D = 64 three
  static constexpr int kStages = D == 128 ? 2 : 3;
  // each bf16 buffer is 1,024-byte aligned (the swizzle atom)
  unsigned char q[kHalves][kHalfBytes];
  unsigned char k[kStages][kHalves][kHalfBytes];
  unsigned char v[kStages][kHalves][kHalfBytes];
  std::conditional_t<kInt8, RawRing<D>, NoRaw> raw;
  // striped: each K tile's key positions, tile i in slot i % kPosSlots
  // (rewritten only once both consumers have folded the tile: see the
  // producer's waits)
  static constexpr int kPosSlots = kStages + 1;
  int tile_pos[kPosSlots][kTile];
  // each key's row in the pool's [n_pages * Hkv * page] rows
  uint32_t tile_slot[kSlotRing][kTile];
  uint64_t q_full;
  uint64_t k_full[kStages], k_empty[kStages];
  uint64_t v_full[kStages], v_empty[kStages];
  // each consumer's rows' positions and key range; the block's walk
  int lo[2], hi[2], seen[2], behind[2], begin[2], end[2];
  int kb, ke;
};

template <int D, bool kInt8>
constexpr size_t smem_bytes() {
  return sizeof(Smem<D, kInt8>) + 1024;  // room to align the base
}

// the 16-byte chunk c (of 8 bf16) of row r of a 128-byte-swizzled tile
// of 64-column halves
__device__ __forceinline__ unsigned char* swz(unsigned char* tile, int r,
                                              int c) {
  return tile + (c >> 3) * kHalfBytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// What the producer warpgroup knows of a block's walk.
template <int D, class Pool, bool kStriped>
struct Producer {
  using Sm = Smem<D, std::is_same<Pool, Int8Pool>::value>;
  static constexpr bool kInt8 = std::is_same<Pool, Int8Pool>::value;
  static constexpr int kS = Sm::kStages;
  Sm& sm;
  Pool pool;
  const int* table;    // row b of the page table
  const int* pos_map;  // kStriped only
  int kh, Hkv, page, kb, ke, tid;
  // this thread's key of the next K tile: its table entry (and pos_map
  // entry), loaded a tile ahead so the read is in flight meanwhile
  int ent = 0, ent_pos = 0;
  // striped: the position of this thread's key of the last even and odd
  // K tiles issued (INT_MAX past ke), written to tile_pos when the tile
  // is finished (K tile 0 is finished after K tile 1's issue)
  int pos_even = 0, pos_odd = 0;

  // the entries of this thread's key of K tile i (clamped to the walk)
  __device__ __forceinline__ void fetch(int i) {
    const int j = min(kb + i * kTile + tid, ke - 1) / page;
    ent = table[j];
    if constexpr (kStriped) ent_pos = pos_map[j];
  }
  __device__ __forceinline__ uint64_t* full(bool is_v, int s) {
    return is_v ? &sm.v_full[s] : &sm.k_full[s];
  }
  __device__ __forceinline__ uint64_t* empty(bool is_v, int s) {
    return is_v ? &sm.v_empty[s] : &sm.k_empty[s];
  }
  __device__ __forceinline__ unsigned char* stage(bool is_v, int s) {
    return is_v ? sm.v[s][0] : sm.k[s][0];
  }

  // Start the copies of K or V tile i: its raw int8 rows into raw slot
  // `rs`, or its bf16 rows straight into its stage once the stage is
  // free; keys past ke are zero-filled.  K's issue first writes each
  // key's pool row (from the entry fetched a tile ahead) into tile_slot,
  // which V's issue of the same tile reads again: a thread rewrites slot
  // i % 3 only after the barrier of tile i + 2's issue, which every
  // thread reaches after its reads of tile i.
  __device__ __forceinline__ void issue(bool is_v, int i, int rs) {
    const int key0 = kb + i * kTile;
    uint32_t* rows = sm.tile_slot[i % kSlotRing];
    if (!is_v) {
      const int key = key0 + tid, lane = min(key, ke - 1) % page;
      rows[tid] = static_cast<uint32_t>(
          (static_cast<size_t>(ent) * Hkv + kh) * page + lane);
      if constexpr (kStriped) {
        const int kp = key < ke ? ent_pos + lane : INT_MAX;
        if (i & 1)
          pos_odd = kp;
        else
          pos_even = kp;
      }
      fetch(i + 1);
    }
    // int8: also every thread is done dequantizing the load that used
    // this raw slot
    if (kInt8 || !is_v) sm90::named_barrier(kProducerBar, 128);
    if constexpr (kInt8) {
      RawSlot<D>& raw = sm.raw.slot[rs];
      const int8_t* src = is_v ? pool.vq : pool.kq;
      constexpr int kC = D / 16;  // 16-byte chunks a raw row
      const int c = tid % kC;
#pragma unroll 4
      for (int r = tid / kC; r < kTile; r += 128 / kC)
        cp_async16(&raw.v[r][c * 16],
                   src + static_cast<size_t>(rows[r]) * D + c * 16,
                   key0 + r < ke);
      // four scales a chunk: key0 is a multiple of 128 and page of 4, so
      // the four keys of a chunk share a page and a 16-byte-aligned
      // address; a chunk past ke reads from row 0, aligned too (cp.async
      // wants its source aligned whatever it copies)
      if (tid < kTile / 4) {
        const float* s = is_v ? pool.vs : pool.ks;
        const bool valid = key0 + 4 * tid < ke;
        cp_async16(&raw.s[4 * tid], s + (valid ? rows[4 * tid] : 0), valid);
      }
    } else {
      const int s = i % kS;
      sm90::mbar_wait(empty(is_v, s), ((i / kS) & 1) ^ 1);
      unsigned char* dst = stage(is_v, s);
      const bf16* src = is_v ? pool.v : pool.k;
      constexpr int kC = D / 8;  // 16-byte chunks a bf16 row
      const int c = tid % kC;
#pragma unroll 4
      for (int r = tid / kC; r < kTile; r += 128 / kC)
        cp_async16(swz(dst, r, c),
                   src + static_cast<size_t>(rows[r]) * D + c * 8,
                   key0 + r < ke);
    }
    cp_async_commit();
  }

  // K or V tile i has landed (this thread's copies: cp.async.wait_group
  // before the call): int8 dequantized into its stage, then the writes
  // fenced for the async proxy (wgmma reads the stage through it) and
  // the stage's full barrier arrived on (128 arrivals)
  __device__ __forceinline__ void finish(bool is_v, int i, int rs) {
    const int s = i % kS;
    if constexpr (kInt8) {
      sm90::named_barrier(kProducerBar, 128);  // everyone's copies landed
      sm90::mbar_wait(empty(is_v, s), ((i / kS) & 1) ^ 1);
      const RawSlot<D>& raw = sm.raw.slot[rs];
      unsigned char* dst = stage(is_v, s);
      constexpr int kC = D / 8;
      const int c = tid % kC;
      for (int r = tid / kC; r < kTile; r += 128 / kC)
        dequant8(reinterpret_cast<bf16*>(swz(dst, r, c)), &raw.v[r][c * 8],
                 raw.s[r]);
    }
    // the global positions of the tile's keys, INT_MAX past ke
    if constexpr (kStriped)
      if (!is_v)
        sm.tile_pos[i % Sm::kPosSlots][tid] = (i & 1) ? pos_odd : pos_even;
    sm90::fence_proxy_async();
    sm90::mbar_arrive(full(is_v, s));
  }

  // K of tile i, then V of tile i - 1; each load's copies are in flight
  // while the previous one is finished
  __device__ __forceinline__ void run(int n) {
    if (n > 0) fetch(0);
    bool have = false, pv = false;
    int pi = 0, n_issued = 0;
    auto step = [&](bool is_v, int i) {
      issue(is_v, i, n_issued & 1);
      ++n_issued;
      if (have) {
        cp_async_wait<1>();
        finish(pv, pi, n_issued & 1);  // the slot before: (n_issued-2)&1
      }
      have = true;
      pv = is_v;
      pi = i;
    };
    for (int i = 0; i <= n; ++i) {
      if (i < n) step(false, i);
      if (i > 0) step(true, i - 1);
    }
    if (have) {
      cp_async_wait<0>();
      finish(pv, pi, (n_issued - 1) & 1);
    }
  }
};

// S = Q K^T for this warpgroup's 64 rows against the 128 keys of stage s
template <int D, bool kInt8>
__device__ __forceinline__ void issue_qk(float (&sc)[64],
                                         const Smem<D, kInt8>& sm, int s,
                                         int cw) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int h = kk / 4, off = (kk % 4) * 32;
    sm90::wgmma_m64n128k16_ss(
        sc, sm90::desc_k_major(sm.q[h] + cw * 64 * 128 + off),
        sm90::desc_k_major(sm.k[s][h] + off), kk > 0);
  }
}

// O += P V over the 128 keys of stage s (V read transposed)
template <int D, bool kInt8>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&p)[8][4],
                                         const Smem<D, kInt8>& sm, int s) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t b =
        sm90::desc_mn_major(sm.v[s][0] + kk * 16 * 128, kHalfBytes);
    if constexpr (D == 128)
      sm90::wgmma_m64n128k16_rs_tb(o, p[kk], b);
    else
      sm90::wgmma_m64n64k16_rs_tb(o, p[kk], b);
  }
}

// The online softmax of one tile's scores, in place, as K1's: sc becomes
// p (f32), m and l carry over, alpha is what O is scaled by.  Register
// 4j + e holds key 8j + 2t + (e & 1) of the tile for row e >> 1.
// kMasked: keep(e, j) decides; otherwise every key is kept.
template <bool kMasked, class Keep>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float scale_log2, Keep keep) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!kMasked || keep(e, j))
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
  }
  float m_new[2], neg_m[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    m_new[h] = fmaxf(m[h], mx[h] > kNegInf ? mx[h] * scale_log2 : kNegInf);
    alpha[h] = exp2_approx(m[h] - m_new[h]);
    neg_m[h] = -m_new[h];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2_approx(fmaf(sc[4 * j + e], scale_log2, neg_m[e >> 1]));
      if (kMasked && !keep(e, j)) p = 0.f;
      sc[4 * j + e] = p;
      sum[e >> 1] += p;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    l[h] = l[h] * alpha[h] + sum[h];
    m[h] = m_new[h];
  }
}

__device__ __forceinline__ void pack_p(uint32_t (&p)[8][4],
                                       const float (&sc)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[kk][r] = pack_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

template <int N>
__device__ __forceinline__ void scale_rows(float (&o)[N],
                                           const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// One consumer warpgroup (cw 0 or 1): rows r_lo .. r_lo + 63 of the
// block's 128.  It walks block tiles [t_lo, t_hi) (its own rows' key
// range) and only waits for and releases the others.
template <int D, bool kInt8, bool kStriped>
__device__ __forceinline__ void consume(Smem<D, kInt8>& sm,
                                        const CUtensorMap* to,
                                        const int* __restrict__ pos_b,
                                        float* __restrict__ m_out,
                                        float* __restrict__ l_out, int bkh,
                                        int r0, int rows, int S, int window,
                                        float scale_log2, int n, int cw) {
  constexpr int kS = Smem<D, kInt8>::kStages;
  const int tid = threadIdx.x - 128 * (cw + 1);  // in the warpgroup
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int r_lo = r0 + 64 * cw;
  const int ra = r_lo + 16 * warp + (lane >> 2);
  const int pa = ra < rows ? pos_b[ra % S] : -1;
  const int pb = ra + 8 < rows ? pos_b[(ra + 8) % S] : -1;
  const int kb = sm.kb, ke = sm.ke;
  // a key is kept by row a (b) where its position lies in (lo_a, hi_a]
  // (past ke none: unstriped by hi, striped by tile_pos's INT_MAX), and
  // by every row of this warpgroup where it lies in (w_lo, w_hi]
  const int hi_a = kStriped ? pa : min(pa, ke - 1);
  const int hi_b = kStriped ? pb : min(pb, ke - 1);
  const int lo_a = window > 0 ? pa - window : INT_MIN;
  const int lo_b = window > 0 ? pb - window : INT_MIN;
  const int w_hi = kStriped ? sm.lo[cw] : min(sm.lo[cw], ke - 1);
  const int w_lo = window > 0 ? sm.hi[cw] - window : INT_MIN;
  // this warpgroup's tiles, warp-uniform to ptxas (a wgmma behind a branch
  // it cannot prove uniform is serialised)
  int t_lo = n, t_hi = n;
  if (sm.begin[cw] < sm.end[cw]) {
    t_lo = (sm.begin[cw] - kb) / kTile;
    t_hi = (sm.end[cw] - kb + kTile - 1) / kTile;
  }
  t_lo = __shfl_sync(0xffffffffu, t_lo, 0);
  t_hi = __shfl_sync(0xffffffffu, t_hi, 0);
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(bar);
  };
  auto skip = [&](int i) {
    const int s = i % kS, ph = (i / kS) & 1;
    sm90::mbar_wait(&sm.k_full[s], ph);
    release(&sm.k_empty[s]);
    sm90::mbar_wait(&sm.v_full[s], ph);
    release(&sm.v_empty[s]);
  };
  // the softmax of tile i, masked unless every row of this warpgroup
  // keeps every key of it
  auto fold = [&](float (&sc)[64], float (&m)[2], float (&l)[2],
                  float (&alpha)[2], int i) {
    const int key0 = kb + i * kTile;
    const int* tp = sm.tile_pos[i % Smem<D, kInt8>::kPosSlots];
    // the position of the tile's key k (positions increase in a tile)
    auto pos = [&](int k) {
      if constexpr (kStriped)
        return tp[k];
      else
        return key0 + k;
    };
    auto keep = [&](int e, int j) {
      const int kp = pos(8 * j + 2 * t + (e & 1));
      return (e >> 1) ? kp <= hi_b && kp > lo_b : kp <= hi_a && kp > lo_a;
    };
    if (pos(kTile - 1) <= w_hi && pos(0) > w_lo)
      softmax_tile<false>(sc, m, l, alpha, scale_log2, keep);
    else
      softmax_tile<true>(sc, m, l, alpha, scale_log2, keep);
  };

  float o[D / 2], sc[64], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float alpha[2];
  uint32_t p[8][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;

  sm90::mbar_wait(&sm.q_full, 0);
  for (int i = 0; i < t_lo; ++i) skip(i);
  if (t_lo < t_hi) {
    {
      const int s = t_lo % kS;
      sm90::mbar_wait(&sm.k_full[s], (t_lo / kS) & 1);
      sm90::wgmma_fence();
      issue_qk<D>(sc, sm, s, cw);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      release(&sm.k_empty[s]);
      fold(sc, m, l, alpha, t_lo);
      pack_p(p, sc);
    }
    for (int i = t_lo + 1; i < t_hi; ++i) {
      // S of tile i, then P V of tile i - 1; the softmax of tile i runs
      // while that P V is in flight
      const int s = i % kS, sp = (i - 1) % kS;
      sm90::mbar_wait(&sm.k_full[s], (i / kS) & 1);
      sm90::fence_regs(sc);
      sm90::wgmma_fence();
      issue_qk<D>(sc, sm, s, cw);
      sm90::wgmma_commit();
      sm90::mbar_wait(&sm.v_full[sp], ((i - 1) / kS) & 1);
      sm90::fence_regs(o);
      sm90::fence_regs(p);
      sm90::wgmma_fence();
      issue_pv<D>(o, p, sm, sp);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // S of tile i has landed
      sm90::fence_regs(sc);
      release(&sm.k_empty[s]);
      fold(sc, m, l, alpha, i);
      sm90::wgmma_wait<0>();  // P V of tile i - 1 has landed
      sm90::fence_regs(o);
      sm90::fence_regs(p);
      release(&sm.v_empty[sp]);
      scale_rows(o, alpha);
      pack_p(p, sc);
    }
    {
      const int j = t_hi - 1, s = j % kS;
      sm90::mbar_wait(&sm.v_full[s], (j / kS) & 1);
      sm90::fence_regs(o);
      sm90::fence_regs(p);
      sm90::wgmma_fence();
      issue_pv<D>(o, p, sm, s);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      release(&sm.v_empty[s]);
    }
  }
  for (int i = t_hi; i < n; ++i) skip(i);

  // epilogue: O / l as bf16 into this warpgroup's Q rows, then one TMA
  // store a half (rows past the kv head's n_rep * S are clipped); a row
  // that kept no key writes 0
  const int bar_id = 1 + cw;
  sm90::named_barrier(bar_id, 128);
  const float la = fmaxf(l[0], 1e-30f), lb = fmaxf(l[1], 1e-30f);
  const int r = 16 * warp + (lane >> 2);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    unsigned char* half = sm.q[j / 8] + cw * 64 * 128;
    const int chunk = ((j % 8) ^ (r % 8)) * 16 + t * 4;
    *reinterpret_cast<uint32_t*>(half + r * 128 + chunk) =
        pack_bf16x2(o[4 * j] / la, o[4 * j + 1] / la);
    *reinterpret_cast<uint32_t*>(half + (r + 8) * 128 + chunk) =
        pack_bf16x2(o[4 * j + 2] / lb, o[4 * j + 3] / lb);
  }
  sm90::fence_proxy_async();
  sm90::named_barrier(bar_id, 128);
  if (tid == 0) {
#pragma unroll
    for (int h = 0; h < Smem<D, kInt8>::kHalves; ++h)
      sm90::tma_store_3d(to, sm.q[h] + cw * 64 * 128, 64 * h, r_lo, bkh);
    sm90::tma_store_commit();
  }
  if constexpr (kStriped) {
    // the rows' softmax partials: m in base e (NEG_INF for a row that
    // kept no key), l unclamped; [B, H, S] row = bkh * rows + r
    if (t == 0) {
      const size_t base = static_cast<size_t>(bkh) * rows;
      if (ra < rows) {
        m_out[base + ra] = m[0] > kNegInf ? m[0] * kLn2 : kNegInf;
        l_out[base + ra] = l[0];
      }
      if (ra + 8 < rows) {
        m_out[base + ra + 8] = m[1] > kNegInf ? m[1] * kLn2 : kNegInf;
        l_out[base + ra + 8] = l[1];
      }
    }
  }
  if (tid == 0) sm90::tma_store_wait_read();
}

template <int D, class Pool, bool kStriped>
__global__ void __launch_bounds__(kBlockThreads, 1)
    paged_prefill_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap to,
                         const Pool pool, const int* __restrict__ table,
                         const int* __restrict__ pos_map,
                         const int* __restrict__ positions,
                         float* __restrict__ m_out,
                         float* __restrict__ l_out, int B, int H, int Hkv,
                         int S, int page, int n_tbl, int window,
                         float scale_log2) {
  constexpr bool kInt8 = std::is_same<Pool, Int8Pool>::value;
  using Sm = Smem<D, kInt8>;
  extern __shared__ unsigned char smem_raw[];
  Sm& sm = sm90::aligned_smem<Sm>(smem_raw);
  const int n_rep = H / Hkv, rows = n_rep * S;
  // Block order: band k of every q head's positions (its last 128
  // positions first: the heaviest causal rows), then (b, kh), then the q
  // head hh, so the n_rep heads of one kv head run side by side.  Band k
  // of head hh is packed rows [hh*S + max(S - 128(k+1), 0), hh*S +
  // S - 128k): it holds the start of one 128-row tile (the last band of a
  // head, shorter, holds one or none).
  const int n_bkh = B * Hkv;
  const int band = blockIdx.x / (n_rep * n_bkh);
  const int bkh = blockIdx.x / n_rep % n_bkh;
  const int hh = blockIdx.x % n_rep;
  const int band_lo = hh * S + max(S - kTile * (band + 1), 0);
  const int band_hi = hh * S + S - kTile * band;
  const int r0 = (band_lo + kTile - 1) / kTile * kTile;
  if (r0 >= band_hi) return;
  const int b = bkh / Hkv, kh = bkh % Hkv;
  const int* pos_b = positions + static_cast<size_t>(b) * S;

  if (threadIdx.x == 0) {
    constexpr int kS = Sm::kStages;
    sm90::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(&sm.k_full[s], 128);
      sm90::mbar_init(&sm.v_full[s], 128);
      sm90::mbar_init(&sm.k_empty[s], kConsumerWarps);
      sm90::mbar_init(&sm.v_empty[s], kConsumerWarps);
    }
    sm90::mbar_fence_init();
  }
  if (threadIdx.x < 2) {
    sm.lo[threadIdx.x] = INT_MAX;
    sm.hi[threadIdx.x] = -1;
    sm.seen[threadIdx.x] = sm.behind[threadIdx.x] = 0;
  }
  __syncthreads();
  // each consumer's rows' positions
  if (threadIdx.x < kTile && r0 + static_cast<int>(threadIdx.x) < rows) {
    const int p = pos_b[(r0 + threadIdx.x) % S];
    atomicMin(&sm.lo[threadIdx.x / 64], p);
    atomicMax(&sm.hi[threadIdx.x / 64], p);
  }
  __syncthreads();
  if constexpr (kStriped) {
    // pos_map increases: the entries a consumer's rows see are a prefix
    // (those starting at or before its last position), and the entries
    // wholly behind every row's window a prefix of that
    int seen[2] = {0, 0}, behind[2] = {0, 0};
    for (int j = threadIdx.x; j < n_tbl; j += kBlockThreads) {
      const int p0 = pos_map[j];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        seen[c] += p0 <= sm.hi[c];
        behind[c] += window > 0 && p0 + page - 1 <= sm.lo[c] - window;
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (seen[c]) atomicAdd(&sm.seen[c], seen[c]);
      if (behind[c]) atomicAdd(&sm.behind[c], behind[c]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    int kb = INT_MAX, ke = 0;
    for (int c = 0; c < 2; ++c) {
      int begin = 0, end = 0;
      if (sm.hi[c] >= 0) {
        if constexpr (kStriped) {
          end = sm.seen[c] * page;
          begin = sm.behind[c] * page;
        } else {
          end = min(sm.hi[c] + 1, n_tbl * page);
          begin = window > 0 ? max(sm.lo[c] - window + 1, 0) : 0;
        }
      }
      if (begin >= end) begin = end = 0;
      if (begin < end) {
        kb = min(kb, begin);
        ke = max(ke, end);
      }
      sm.begin[c] = begin;
      sm.end[c] = end;
    }
    sm.kb = kb < ke ? kb / kTile * kTile : 0;
    sm.ke = kb < ke ? ke : 0;
  }
  __syncthreads();
  const int kb = sm.kb, ke = sm.ke;
  const int n = (ke - kb + kTile - 1) / kTile;

  // The two paths never join again (ptxas honours setmaxnreg only then).
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(&sm.q_full, Sm::kHalves * kHalfBytes);
#pragma unroll
      for (int h = 0; h < Sm::kHalves; ++h)
        sm90::tma_load_3d(sm.q[h], &tq, &sm.q_full, 64 * h, r0, bkh);
    }
    const int* table_b = table + static_cast<size_t>(b) * n_tbl;
    Producer<D, Pool, kStriped>{sm, pool, table_b, pos_map, kh, Hkv, page,
                                kb, ke, static_cast<int>(threadIdx.x)}
        .run(n);
  } else {
    sm90::setmaxnreg_inc<kConsumerRegs>();
    consume<D, kInt8, kStriped>(sm, &to, pos_b, m_out, l_out, bkh, r0, rows,
                                S, window, scale_log2, n, wg - 1);
  }
}

template <int D, bool kStriped, class Pool>
static int launch(const Pool& pool, const Args& a, cudaStream_t stream) {
  constexpr bool kInt8 = std::is_same<Pool, Int8Pool>::value;
  const int n_rep = a.H / a.Hkv, rows = n_rep * a.S;
  CUtensorMap tq, to;
  // q and out as [B * Hkv, n_rep * S, D]: the q heads of kv head kh are
  // one contiguous slab, row r = head kh * n_rep + r / S at position r % S
  if (!sm90::make_tmap_bf16_3d(&tq, a.q, a.B * a.Hkv, rows, D, kTile) ||
      !sm90::make_tmap_bf16_3d(&to, a.o, a.B * a.Hkv, rows, D, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = smem_bytes<D, kInt8>();
  static_assert(smem <= 232448, "more shared memory than a block may have");
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_prefill_kernel<D, Pool, kStriped>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int bands = (a.S + kTile - 1) / kTile;
  paged_prefill_kernel<D, Pool, kStriped>
      <<<bands * n_rep * a.B * a.Hkv, kBlockThreads, smem, stream>>>(
          tq, to, pool, static_cast<const int*>(a.table),
          static_cast<const int*>(a.pos_map),
          static_cast<const int*>(a.positions), static_cast<float*>(a.m),
          static_cast<float*>(a.l), a.B, a.H, a.Hkv, a.S, a.page, a.n_tbl,
          a.window, a.scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStriped, class Pool>
static int dispatch(const Pool& pool, const Args& a, void* stream) {
  if (a.B < 1 || a.S < 1 || a.Hkv < 1 || a.H % a.Hkv != 0 || a.page < 1 ||
      a.n_tbl < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a.D) {
    case 64:
      return prefill::launch<64, kStriped>(pool, a, st);
    case 128:
      return prefill::launch<128, kStriped>(pool, a, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace prefill

}  // namespace tpushare

// Each entry point returns cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue for what it does not take: a head
// dim other than 64 or 128.
extern "C" int tpushare_paged_attn(const void* q, const void* kpool,
                                   const void* vpool, const void* table,
                                   const void* positions, void* o, int B,
                                   int H, int Hkv, int S, int D, int page,
                                   int n_tbl, int window, float scale,
                                   void* stream) {
  const tpushare::Bf16Pool pool{static_cast<const tpushare::bf16*>(kpool),
                                static_cast<const tpushare::bf16*>(vpool)};
  return tpushare::prefill::dispatch<false>(
      pool, {q, table, nullptr, positions, o, nullptr, nullptr, B, H, Hkv,
             S, D, page, n_tbl, window, scale},
      stream);
}

// The int8 store: kq/vq int8 [n_pages, Hkv, page, D], ks/vs f32 [n_pages,
// Hkv, page, 1], all 16-byte aligned; page % 4 == 0.
extern "C" int tpushare_paged_attn_int8(
    const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* table, const void* positions, void* o, int B,
    int H, int Hkv, int S, int D, int page, int n_tbl, int window,
    float scale, void* stream) {
  if (page % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return tpushare::prefill::dispatch<false>(
      tpushare::int8_pool(kq, ks, vq, vs),
      {q, table, nullptr, positions, o, nullptr, nullptr, B, H, Hkv, S, D,
       page, n_tbl, window, scale},
      stream);
}

// The striped variants: pos_map int32 [n_tbl] (increasing) gives each
// table entry's starting position; m and l f32 [B, H, S] receive the rows'
// softmax partials.
extern "C" int tpushare_paged_attn_striped(
    const void* q, const void* kpool, const void* vpool, const void* table,
    const void* pos_map, const void* positions, void* o, void* m, void* l,
    int B, int H, int Hkv, int S, int D, int page, int n_tbl, int window,
    float scale, void* stream) {
  const tpushare::Bf16Pool pool{static_cast<const tpushare::bf16*>(kpool),
                                static_cast<const tpushare::bf16*>(vpool)};
  return tpushare::prefill::dispatch<true>(
      pool, {q, table, pos_map, positions, o, m, l, B, H, Hkv, S, D, page,
             n_tbl, window, scale},
      stream);
}

extern "C" int tpushare_paged_attn_int8_striped(
    const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* table, const void* pos_map,
    const void* positions, void* o, void* m, void* l, int B, int H, int Hkv,
    int S, int D, int page, int n_tbl, int window, float scale,
    void* stream) {
  if (page % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return tpushare::prefill::dispatch<true>(
      tpushare::int8_pool(kq, ks, vq, vs),
      {q, table, pos_map, positions, o, m, l, B, H, Hkv, S, D, page, n_tbl,
       window, scale},
      stream);
}
