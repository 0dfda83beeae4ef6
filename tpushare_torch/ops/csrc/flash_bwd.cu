// K3 and K4: the flash attention backward for Hopper (sm_90a).
//
// Replaces tpushare/ops/attention.py::_flash_bwd_dkv_kernel (K3) and
// ::_flash_bwd_dq_kernel (K4), the Pallas TPU kernels launched by
// _flash_bwd_pallas.  For q, dO [B, H, S, D], k, v [B, Hkv, S, D] (bf16,
// H % Hkv == 0), the forward's lse [B, H, S] (f32, scaled scores, base e)
// and dvec = rowsum(dO * O) - g_lse [B, H, S] (f32), with the
// FlashAttention-2 identities per (query i, key j):
//   P   = exp(S - lse_i)                 (S = scale * q k^T, masked)
//   dV  = sum_i bf16(P)^T dO_i
//   dS  = P * (dO_i v^T - dvec_i)
//   dK  = scale * sum_i bf16(dS)^T q_i   (K3)
//   dQ  = scale * sum_j bf16(dS) k_j     (K4)
// P is recomputed from the stored lse, P and dS are rounded to bf16 before
// their second product (as on the TPU), every sum is f32, the GQA group is
// summed per kv head, and each output is rounded to bf16 once.  dK's and
// dQ's scale is applied once at the end (the TPU kernel scales each
// q-block's partial sum of dK; the same f32 sum up to reassociation).  The
// exponent is one FMA in base 2: s * scale * log2(e) - lse * log2(e).
//
// Bound on an H100: operations.  At the training shape (B = 1, S = 2048,
// H = 32 over Hkv = 8, D = 128, causal) K3 does four causal products
// (68.8 GFLOP) and K4 three (51.6 GFLOP) against ~50 MB of operands, far
// above the card's ~295 FLOP/byte bf16 ridge.  Both kernels are built
// like K1 (flash_fwd.cu) on the blocks of sm90.cuh: a producer warp feeds
// 128-byte-swizzled tiles by TMA into mbarrier rings, two consumer
// warpgroups (setmaxnreg 240) run every product on wgmma, and the two
// paths never join again.  No atomics: each output element is written by
// one block, so the result is the same from run to run.
//
// * K4 (dQ): one block per (b, q head, 128-query tile), 64 rows a consumer
//   warpgroup; Q and dO arrive once, K and V tiles of 64 keys stream
//   through a ring.  S = Q K^T and dP = dO V^T (both SS, K-major), dS in
//   registers from the row's lse and dvec, then dQ += dS K (RS: the S
//   accumulator layout is the A fragment; K's one swizzled tile is read
//   K-major by the first product and MN-major by this one).  Tile j's S
//   and dP are issued before tile j - 1's dQ product, so dS of tile j is
//   computed while that product is in flight.  The key walk is the
//   forward's (the TPU kernel's skip bounds, :286-293); heaviest causal
//   q-tiles launch first.
// * K3 (dK, dV): one block per (b, kv head, 64-key tile).  The transposed
//   products S^T = K Q^T and dP^T = V dO^T (SS) put P^T and dS^T in
//   registers as the A operand of dV += bf16(P^T) dO and dK += bf16(dS^T)
//   Q (RS, dO and Q read MN-major), so nothing goes back to shared memory.
//   lse and dvec are per column here (one a query): the consuming
//   warpgroup stages each q tile's 64 of each in shared memory, loading
//   them one item ahead.  The block walks the
//   q tiles of all n_rep q heads of its kv head (the TPU kernel's skip
//   bounds, :233-242), the two warpgroups taking alternate tiles, each
//   with its own 64 x D dK and dV partials in registers; the partials are
//   summed through the freed ring at the end.  64-key blocks, heaviest
//   causal key tiles first: at the training shape 256 blocks, the heaviest
//   about 1.03x an SM's share of the causal work (128-key blocks would be
//   128 blocks and 2.05x).
//
// Masking is done on registers, never by skipping a wgmma: tiles that the
// causal range or the window leave whole are computed unmasked, the rest
// with the mask.  Rows past S arrive as zeros (TMA fill): a padded query
// scores 0 and its P = exp(-lse) is not 0, so K3 masks queries >= S and
// both mask keys >= S; the TMA stores clip rows past S.
#include "attn_tile.cuh"
#include "sm90.cuh"

namespace tpushare {
namespace bwd {

constexpr int kTile = 64;                   // keys a K3 block, a K4 tile;
                                            // queries a K3 tile
constexpr int kHalfBytes = kTile * 64 * 2;  // one 64-column half of a tile
constexpr int kConsumers = 2;               // warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);

// acc (+)= A B^T over D (both K-major): A is a 64-row tile with
// descriptor `da` whose 64-column halves lie a_half bytes apart, B a
// 64-row tile with descriptor `db` whose halves lie kHalfBytes apart.
// Each k16 step's descriptor is the base one plus its byte offset >> 4
// (the start address field; a tile lies below 256 KB, so no carry).
template <int D>
__device__ __forceinline__ void issue_ss(float (&acc)[32], uint64_t da,
                                         int a_half, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int h = kk / 4, off = (kk % 4) * 32;
    sm90::wgmma_m64n64k16_ss(acc, da + ((h * a_half + off) >> 4),
                             db + ((h * kHalfBytes + off) >> 4), kk > 0);
  }
}

// acc += A B over a 64-row tile at `b` read MN-major (B[row][d]); A the
// bf16 fragments of a 64 x 64 accumulator
template <int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2],
                                         const uint32_t (&a)[4][4],
                                         const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc =
        sm90::desc_mn_major(b + kk * 16 * 128, kHalfBytes);
    if constexpr (D == 128)
      sm90::wgmma_m64n128k16_rs_tb(acc, a[kk], desc);
    else
      sm90::wgmma_m64n64k16_rs_tb(acc, a[kk], desc);
  }
}

// bf16 A fragments of a 64 x 64 accumulator: slice kk is its 8-column
// blocks 2kk and 2kk + 1
__device__ __forceinline__ void pack_frags(uint32_t (&f)[4][4],
                                           const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      f[kk][r] = pack_bf16x2(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// a warpgroup's 64 x D accumulator times `scale`, as bf16, into the
// swizzled tile rows at `base` (1,024-byte aligned) whose halves lie
// half_bytes apart: what a TMA store of the tile reads
template <int D>
__device__ __forceinline__ void stage_out(unsigned char* base, int half_bytes,
                                          const float (&acc)[D / 2],
                                          float scale, int tid) {
  const int lane = tid & 31;
  const int r = 16 * (tid >> 5) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    unsigned char* half = base + (j / 8) * half_bytes;
    const int chunk = ((j % 8) ^ (r % 8)) * 16 + (lane & 3) * 4;
    *reinterpret_cast<uint32_t*>(half + r * 128 + chunk) =
        pack_bf16x2(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    *reinterpret_cast<uint32_t*>(half + (r + 8) * 128 + chunk) =
        pack_bf16x2(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

__device__ __forceinline__ bool keep(int query, int key, int S, int causal,
                                     int window) {
  return query < S && key < S &&
         (!causal || (key <= query && (window <= 0 || key > query - window)));
}

// ---------------------------------------------------------------------------
// K4: dQ
// ---------------------------------------------------------------------------
namespace k4 {

constexpr int kRows = 2 * kTile;  // query rows a block

template <int D>
struct Smem {
  static constexpr int kHalves = D / 64;
  // D = 128: 64 KB of Q and dO and three stages of K and V, 160 KB
  static constexpr int kStages = D == 128 ? 3 : 4;
  unsigned char q[kHalves][2 * kHalfBytes];
  unsigned char dout[kHalves][2 * kHalfBytes];
  unsigned char k[kStages][kHalves][kHalfBytes];
  unsigned char v[kStages][kHalves][kHalfBytes];
  uint64_t q_full;
  uint64_t k_full[kStages], k_empty[kStages];
  uint64_t v_full[kStages], v_empty[kStages];
};

// the key tiles a block walks: [begin, begin + n * kTile)
struct Walk {
  int begin, n;
};

__device__ __forceinline__ Walk walk_of(int q0, int S, int causal,
                                        int window) {
  const int end = causal ? min(q0 + kRows, S) : S;
  const int begin =
      (causal && window > 0) ? max(q0 - window + 1, 0) / kTile * kTile : 0;
  return {begin, (end - begin + kTile - 1) / kTile};
}

template <int D>
__device__ __forceinline__ void produce(Smem<D>& sm, const CUtensorMap* tq,
                                        const CUtensorMap* tdo,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, int bh,
                                        int kv_row, int q0, Walk w) {
  using sm90::tma_load_3d;
  constexpr int kH = Smem<D>::kHalves, kS = Smem<D>::kStages;
  sm90::mbar_arrive_expect_tx(&sm.q_full, 2 * kH * 2 * kHalfBytes);
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    tma_load_3d(sm.q[h], tq, &sm.q_full, 64 * h, q0, bh);
    tma_load_3d(sm.dout[h], tdo, &sm.q_full, 64 * h, q0, bh);
  }
  for (int i = 0; i < w.n; ++i) {
    const int s = i % kS, key0 = w.begin + i * kTile;
    const uint32_t parity = ((i / kS) & 1) ^ 1;
    sm90::mbar_wait(&sm.k_empty[s], parity);
    sm90::mbar_arrive_expect_tx(&sm.k_full[s], kH * kHalfBytes);
#pragma unroll
    for (int h = 0; h < kH; ++h)
      tma_load_3d(sm.k[s][h], tk, &sm.k_full[s], 64 * h, key0, kv_row);
    sm90::mbar_wait(&sm.v_empty[s], parity);
    sm90::mbar_arrive_expect_tx(&sm.v_full[s], kH * kHalfBytes);
#pragma unroll
    for (int h = 0; h < kH; ++h)
      tma_load_3d(sm.v[s][h], tv, &sm.v_full[s], 64 * h, key0, kv_row);
  }
}

// P from the row's lse, then dS = P (dP - dvec) in place of dP.  This
// thread's rows are ra and ra + 8; register 4j + e holds key
// key0 + 8j + 2t + (e & 1) of row e >> 1.
template <bool kMasked>
__device__ __forceinline__ void ds_tile(const float (&sc)[32],
                                        float (&dp)[32],
                                        const float (&lse2)[2],
                                        const float (&dvr)[2],
                                        float scale_log2, int key0, int ra,
                                        int S, int causal, int window) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float p = exp2_approx(fmaf(sc[4 * j + e], scale_log2, -lse2[h]));
      if (kMasked &&
          !keep(ra + 8 * h, key0 + 8 * j + 2 * t + (e & 1), S, causal,
                window))
        p = 0.f;
      dp[4 * j + e] = p * (dp[4 * j + e] - dvr[h]);
    }
  }
}

// dS of the tile at key0, masked unless every row of this warpgroup
// (r_lo .. r_lo + 63) keeps every key of it
__device__ __forceinline__ void ds_fold(const float (&sc)[32],
                                        float (&dp)[32],
                                        const float (&lse2)[2],
                                        const float (&dvr)[2],
                                        float scale_log2, int key0, int ra,
                                        int r_lo, int S, int causal,
                                        int window) {
  const bool whole =
      key0 + kTile <= S &&
      (!causal || (key0 + kTile - 1 <= r_lo &&
                   (window <= 0 || key0 > r_lo + 63 - window)));
  if (whole)
    ds_tile<false>(sc, dp, lse2, dvr, scale_log2, key0, ra, S, causal,
                   window);
  else
    ds_tile<true>(sc, dp, lse2, dvr, scale_log2, key0, ra, S, causal,
                  window);
}

template <int D>
__device__ __forceinline__ void consume(Smem<D>& sm, const CUtensorMap* tdq,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ dvec,
                                        int bh, int q0, int S, int causal,
                                        int window, float scale,
                                        float scale_log2, Walk w, int wg) {
  constexpr int kS = Smem<D>::kStages;
  const int tid = threadIdx.x - 128 * (wg + 1);  // in the warpgroup
  const int warp = tid >> 5, lane = tid & 31;
  const int r_lo = q0 + 64 * wg;                 // this warpgroup's rows
  const int ra = r_lo + 16 * warp + (lane >> 2);
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(bar);
  };
  const size_t head = static_cast<size_t>(bh) * S;
  float lse2[2], dvr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = ra + 8 * h;
    lse2[h] = row < S ? lse[head + row] * kLog2e : 0.f;
    dvr[h] = row < S ? dvec[head + row] : 0.f;
  }
  // this warpgroup's 64 rows of Q and dO (A operands, halves 2 tiles
  // apart)
  const uint64_t qd = sm90::desc_k_major(sm.q[0] + wg * 64 * 128);
  const uint64_t dd = sm90::desc_k_major(sm.dout[0] + wg * 64 * 128);

  float dq[D / 2], sc[32], dp[32];
  uint32_t f[4][4];
  zero(dq);
  zero(sc);
  zero(dp);

  sm90::mbar_wait(&sm.q_full, 0);
  // tile 0: S and dP, then its dS
  sm90::mbar_wait(&sm.k_full[0], 0);
  sm90::mbar_wait(&sm.v_full[0], 0);
  sm90::wgmma_fence();
  issue_ss<D>(sc, qd, 2 * kHalfBytes, sm90::desc_k_major(sm.k[0][0]));
  issue_ss<D>(dp, dd, 2 * kHalfBytes, sm90::desc_k_major(sm.v[0][0]));
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sc);
  sm90::fence_regs(dp);
  release(&sm.v_empty[0]);
  ds_fold(sc, dp, lse2, dvr, scale_log2, w.begin, ra, r_lo, S, causal,
          window);
  pack_frags(f, dp);
  for (int i = 1; i < w.n; ++i) {
    // issue S and dP of tile i, then dQ of tile i - 1; dS of tile i is
    // computed while that product is in flight
    const int s = i % kS, sp = (i - 1) % kS;
    sm90::mbar_wait(&sm.k_full[s], (i / kS) & 1);
    sm90::mbar_wait(&sm.v_full[s], (i / kS) & 1);
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    sm90::wgmma_fence();
    issue_ss<D>(sc, qd, 2 * kHalfBytes, sm90::desc_k_major(sm.k[s][0]));
    issue_ss<D>(dp, dd, 2 * kHalfBytes, sm90::desc_k_major(sm.v[s][0]));
    sm90::wgmma_commit();
    sm90::fence_regs(dq);
    sm90::fence_regs(f);
    sm90::wgmma_fence();
    issue_rs<D>(dq, f, sm.k[sp][0]);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // S and dP of tile i have landed
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    release(&sm.v_empty[s]);
    ds_fold(sc, dp, lse2, dvr, scale_log2, w.begin + i * kTile, ra, r_lo, S,
            causal, window);
    sm90::wgmma_wait<0>();  // dQ of tile i - 1 has landed
    sm90::fence_regs(dq);
    sm90::fence_regs(f);
    release(&sm.k_empty[sp]);
    pack_frags(f, dp);
  }
  // dQ of the last tile
  {
    const int s = (w.n - 1) % kS;
    sm90::fence_regs(dq);
    sm90::fence_regs(f);
    sm90::wgmma_fence();
    issue_rs<D>(dq, f, sm.k[s][0]);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dq);
    release(&sm.k_empty[s]);
  }

  // epilogue: scale * dQ as bf16 into this warpgroup's Q rows (every
  // wgmma that read them is done once the warpgroup meets here), then one
  // TMA store a half; rows past S are clipped by the store
  const int bar_id = 1 + wg;
  sm90::named_barrier(bar_id, 128);
  stage_out<D>(sm.q[0] + wg * 64 * 128, 2 * kHalfBytes, dq, scale, tid);
  sm90::fence_proxy_async();
  sm90::named_barrier(bar_id, 128);
  if (tid == 0) {
#pragma unroll
    for (int h = 0; h < Smem<D>::kHalves; ++h)
      sm90::tma_store_3d(tdq, sm.q[h] + wg * 64 * 128, 64 * h, r_lo, bh);
    sm90::tma_store_commit();
    sm90::tma_store_wait_read();
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdq,
              const float* __restrict__ lse, const float* __restrict__ dvec,
              int H, int Hkv, int S, int causal, int window, float scale,
              float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  Smem<D>& sm = sm90::aligned_smem<Smem<D>>(smem_raw);
  // heaviest causal q-tile first; within a q-tile, heads in order, so the
  // n_rep heads of one kv head run side by side
  const int n_tiles = (S + kRows - 1) / kRows;
  const int n_bh = gridDim.x / n_tiles;
  const int q0 = (n_tiles - 1 - blockIdx.x / n_bh) * kRows;
  const int bh = blockIdx.x % n_bh;
  const int kv_row = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const Walk w = walk_of(q0, S, causal, window);

  if (threadIdx.x == 0) {
    constexpr int kS = Smem<D>::kStages;
    sm90::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(&sm.k_full[s], 1);
      sm90::mbar_init(&sm.v_full[s], 1);
      sm90::mbar_init(&sm.k_empty[s], 4 * kConsumers);
      sm90::mbar_init(&sm.v_empty[s], 4 * kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // the producer and consumer paths never join again (see flash_fwd.cu)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 0)
      produce<D>(sm, &tq, &tdo, &tk, &tv, bh, kv_row, q0, w);
  } else {
    sm90::setmaxnreg_inc<240>();
    consume<D>(sm, &tdq, lse, dvec, bh, q0, S, causal, window, scale,
               scale_log2, w, wg - 1);
  }
}

template <int D>
static int launch(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* dvec,
                  void* dq, int B, int H, int Hkv, int S, int causal,
                  int window, float scale, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv, tdq;
  if (!sm90::make_tmap_bf16_3d(&tq, q, B * H, S, D, kRows) ||
      !sm90::make_tmap_bf16_3d(&tdo, dout, B * H, S, D, kRows) ||
      !sm90::make_tmap_bf16_3d(&tk, k, B * Hkv, S, D, kTile) ||
      !sm90::make_tmap_bf16_3d(&tv, v, B * Hkv, S, D, kTile) ||
      !sm90::make_tmap_bf16_3d(&tdq, dq, B * H, S, D, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = sizeof(Smem<D>) + 1024;  // room to align
  static const cudaError_t attr = cudaFuncSetAttribute(
      dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_tiles = (S + kRows - 1) / kRows;
  dq_kernel<D><<<n_tiles * B * H, kThreads, smem, stream>>>(
      tq, tdo, tk, tv, tdq, static_cast<const float*>(lse),
      static_cast<const float*>(dvec), H, Hkv, S, causal, window, scale,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k4

// ---------------------------------------------------------------------------
// K3: dK, dV
// ---------------------------------------------------------------------------
namespace k3 {

template <int D>
struct Smem {
  static constexpr int kHalves = D / 64;
  // a ring of q tiles (q, dO, their lse * log2(e) and dvec): two stages a
  // consumer warpgroup; 162 KB at D = 128
  static constexpr int kStages = 4;
  unsigned char k[kHalves][kHalfBytes];
  unsigned char v[kHalves][kHalfBytes];
  // q and dout are contiguous: the epilogue sums the partials there
  unsigned char q[kStages][kHalves][kHalfBytes];
  unsigned char dout[kStages][kHalves][kHalfBytes];
  // each q tile's lse * log2(e) ([0]) and dvec ([1]), 0 past S, written
  // by the consuming warpgroup (it owns stages wg and wg + 2)
  float stats[kStages][2][kTile];
  uint64_t kv_full;
  uint64_t q_full[kStages], q_empty[kStages];
};

// the q tiles of one q head: [begin, begin + n * kTile)
struct Walk {
  int begin, n;
};

__device__ __forceinline__ Walk walk_of(int k0, int S, int causal,
                                        int window) {
  // causal: no query before k0 sees the tile; window: query i sees key j
  // only while i < j + window
  const int begin = causal ? k0 : 0;
  const int end =
      (causal && window > 0) ? min(S, k0 + kTile - 1 + window) : S;
  return {begin, (end - begin + kTile - 1) / kTile};
}

// The producer: the block's K and V tile once, then each (q head, q tile)
// in turn, head-major, q and dO by TMA.
template <int D>
__device__ __forceinline__ void produce(Smem<D>& sm, const CUtensorMap* tq,
                                        const CUtensorMap* tdo,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, int bh0,
                                        int bkv, int k0, Walk w, int n_it) {
  using sm90::tma_load_3d;
  constexpr int kH = Smem<D>::kHalves, kS = Smem<D>::kStages;
  sm90::mbar_arrive_expect_tx(&sm.kv_full, 2 * kH * kHalfBytes);
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    tma_load_3d(sm.k[h], tk, &sm.kv_full, 64 * h, k0, bkv);
    tma_load_3d(sm.v[h], tv, &sm.kv_full, 64 * h, k0, bkv);
  }
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kS;
    const int bh = bh0 + it / w.n;
    const int q0 = w.begin + (it % w.n) * kTile;
    sm90::mbar_wait(&sm.q_empty[s], ((it / kS) & 1) ^ 1);
    sm90::mbar_arrive_expect_tx(&sm.q_full[s], 2 * kH * kHalfBytes);
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      tma_load_3d(sm.q[s][h], tq, &sm.q_full[s], 64 * h, q0, bh);
      tma_load_3d(sm.dout[s][h], tdo, &sm.q_full[s], 64 * h, q0, bh);
    }
  }
}

// Thread tid's share of item it's row statistics: lse * log2(e) of the
// q tile's query tid (tid < 64), or dvec of query tid - 64; 0 past S.
__device__ __forceinline__ float stat_of(const float* __restrict__ lse,
                                         const float* __restrict__ dvec,
                                         int bh0, int S, Walk w, int it,
                                         int tid) {
  const int q = w.begin + (it % w.n) * kTile + (tid & (kTile - 1));
  if (q >= S) return 0.f;
  const size_t i = static_cast<size_t>(bh0 + it / w.n) * S + q;
  return tid < kTile ? lse[i] * kLog2e : dvec[i];
}

// P^T from each column's (query's) lse, then dS^T = P^T (dP^T - dvec), in
// place.  This thread's rows are keys key_a and key_a + 8; register 4j + e
// holds query q0 + 8j + 2t + (e & 1) of row e >> 1.
template <bool kMasked>
__device__ __forceinline__ void p_ds_tile(float (&st)[32], float (&dpt)[32],
                                          const float* lse2,
                                          const float* dvec,
                                          float scale_log2, int key_a,
                                          int q0, int S, int causal,
                                          int window) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
    const float2 dd = *reinterpret_cast<const float2*>(dvec + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2_approx(
          fmaf(st[4 * j + e], scale_log2, -((e & 1) ? l.y : l.x)));
      if (kMasked && !keep(q0 + 8 * j + 2 * t + (e & 1), key_a + 8 * (e >> 1),
                           S, causal, window))
        p = 0.f;
      st[4 * j + e] = p;
      dpt[4 * j + e] = p * (dpt[4 * j + e] - ((e & 1) ? dd.y : dd.x));
    }
  }
}

// consumer warpgroup wg (a constant, so its barrier id and its share of
// the items need no register)
template <int D, int wg>
__device__ __forceinline__ void consume(Smem<D>& sm, const CUtensorMap* tdk,
                                        const CUtensorMap* tdv,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ dvec,
                                        int bh0, int bkv, int k0, int S,
                                        int causal, int window, float scale,
                                        float scale_log2, Walk w, int n_it) {
  constexpr int kS = Smem<D>::kStages;
  const int tid = threadIdx.x - 128 * (wg + 1);  // in the warpgroup
  const int warp = tid >> 5, lane = tid & 31;
  const int key_a = k0 + 16 * warp + (lane >> 2);

  float dk[D / 2], dv[D / 2], st[32], dpt[32];
  uint32_t pf[4][4], sf[4][4];
  zero(dk);
  zero(dv);

  // the block's K and V tiles (A operands)
  const uint64_t kd = sm90::desc_k_major(sm.k[0]);
  const uint64_t vd = sm90::desc_k_major(sm.v[0]);
  // the row statistics of this warpgroup's first item; each item then
  // loads its next item's while it runs (a barrier of the warpgroup makes
  // them visible before that item reads them)
  constexpr int bar_id = 2 + wg;
  if (wg < n_it)
    sm.stats[wg % kS][tid / kTile][tid % kTile] =
        stat_of(lse, dvec, bh0, S, w, wg, tid);
  sm90::named_barrier(bar_id, 128);
  sm90::mbar_wait(&sm.kv_full, 0);
  // the two warpgroups take alternate (q head, q tile) items
  for (int it = wg; it < n_it; it += kConsumers) {
    const int nxt = it + kConsumers;
    const float next_stat =
        nxt < n_it ? stat_of(lse, dvec, bh0, S, w, nxt, tid) : 0.f;
    const int s = it % kS;
    const int q0 = w.begin + (it % w.n) * kTile;
    sm90::mbar_wait(&sm.q_full[s], (it / kS) & 1);
    // S^T = K q^T and dP^T = V dO^T; zeroed first, so no value of the
    // last item stays live beside the fragments
    zero(st);
    zero(dpt);
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);
    sm90::wgmma_fence();
    issue_ss<D>(st, kd, kHalfBytes, sm90::desc_k_major(sm.q[s][0]));
    issue_ss<D>(dpt, vd, kHalfBytes, sm90::desc_k_major(sm.dout[s][0]));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);
    const bool whole =
        q0 + kTile <= S && k0 + kTile <= S &&
        (!causal || (k0 + kTile - 1 <= q0 &&
                     (window <= 0 || k0 > q0 + kTile - 1 - window)));
    if (whole)
      p_ds_tile<false>(st, dpt, sm.stats[s][0], sm.stats[s][1], scale_log2,
                       key_a, q0, S, causal, window);
    else
      p_ds_tile<true>(st, dpt, sm.stats[s][0], sm.stats[s][1], scale_log2,
                      key_a, q0, S, causal, window);
    pack_frags(pf, st);
    pack_frags(sf, dpt);
    // dV += bf16(P^T) dO and dK += bf16(dS^T) q
    sm90::fence_regs(dk);
    sm90::fence_regs(dv);
    sm90::fence_regs(pf);
    sm90::fence_regs(sf);
    sm90::wgmma_fence();
    issue_rs<D>(dv, pf, sm.dout[s][0]);
    issue_rs<D>(dk, sf, sm.q[s][0]);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dk);
    sm90::fence_regs(dv);
    sm90::fence_regs(pf);
    sm90::fence_regs(sf);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&sm.q_empty[s]);
    if (nxt < n_it) sm.stats[nxt % kS][tid / kTile][tid % kTile] = next_stat;
    sm90::named_barrier(bar_id, 128);
  }

  // epilogue: both warpgroups are past their last wgmma and every q tile
  // has been consumed, so the ring is free.  Warpgroup 0 sends its dV
  // partial, warpgroup 1 its dK partial, through it (thread t of one
  // holds the elements thread t of the other does); each then finishes
  // one output into the block's K or V tile and stores it by TMA (rows
  // past S clipped).
  constexpr int kN = D / 2;
  float* xch = reinterpret_cast<float*>(sm.q[0][0]);
  sm90::named_barrier(1, 256);
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < kN; ++i) xch[i * 128 + tid] = dv[i];
  } else {
#pragma unroll
    for (int i = 0; i < kN; ++i) xch[(kN + i) * 128 + tid] = dk[i];
  }
  sm90::named_barrier(1, 256);
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < kN; ++i) dk[i] += xch[(kN + i) * 128 + tid];
    stage_out<D>(sm.k[0], kHalfBytes, dk, scale, tid);
  } else {
#pragma unroll
    for (int i = 0; i < kN; ++i) dv[i] += xch[i * 128 + tid];
    stage_out<D>(sm.v[0], kHalfBytes, dv, 1.f, tid);
  }
  sm90::fence_proxy_async();
  sm90::named_barrier(bar_id, 128);
  if (tid == 0) {
#pragma unroll
    for (int h = 0; h < Smem<D>::kHalves; ++h) {
      if (wg == 0)
        sm90::tma_store_3d(tdk, sm.k[h], 64 * h, k0, bkv);
      else
        sm90::tma_store_3d(tdv, sm.v[h], 64 * h, k0, bkv);
    }
    sm90::tma_store_commit();
    sm90::tma_store_wait_read();
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdk,
               const __grid_constant__ CUtensorMap tdv,
               const float* __restrict__ lse, const float* __restrict__ dvec,
               int H, int Hkv, int S, int causal, int window, float scale,
               float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  Smem<D>& sm = sm90::aligned_smem<Smem<D>>(smem_raw);
  // heaviest causal key tile first; within a key tile, kv heads in order
  const int n_bkv = gridDim.x / ((S + kTile - 1) / kTile);
  const int k0 = blockIdx.x / n_bkv * kTile;
  const int bkv = blockIdx.x % n_bkv;  // b * Hkv + kv head
  const int n_rep = H / Hkv;
  const int bh0 = (bkv / Hkv) * H + (bkv % Hkv) * n_rep;  // first q head
  const Walk w = walk_of(k0, S, causal, window);
  const int n_it = n_rep * w.n;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < Smem<D>::kStages; ++s) {
      sm90::mbar_init(&sm.q_full[s], 1);
      sm90::mbar_init(&sm.q_empty[s], 4);   // the consuming warpgroup
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // the producer and consumer paths never join again (see flash_fwd.cu)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 0)
      produce<D>(sm, &tq, &tdo, &tk, &tv, bh0, bkv, k0, w, n_it);
  } else {
    sm90::setmaxnreg_inc<240>();
    if (wg == 1)
      consume<D, 0>(sm, &tdk, &tdv, lse, dvec, bh0, bkv, k0, S, causal,
                    window, scale, scale_log2, w, n_it);
    else
      consume<D, 1>(sm, &tdk, &tdv, lse, dvec, bh0, bkv, k0, S, causal,
                    window, scale, scale_log2, w, n_it);
  }
}

template <int D>
static int launch(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* dvec,
                  void* dk, void* dv, int B, int H, int Hkv, int S,
                  int causal, int window, float scale, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv, tdk, tdv;
  if (!sm90::make_tmap_bf16_3d(&tq, q, B * H, S, D, kTile) ||
      !sm90::make_tmap_bf16_3d(&tdo, dout, B * H, S, D, kTile) ||
      !sm90::make_tmap_bf16_3d(&tk, k, B * Hkv, S, D, kTile) ||
      !sm90::make_tmap_bf16_3d(&tv, v, B * Hkv, S, D, kTile) ||
      !sm90::make_tmap_bf16_3d(&tdk, dk, B * Hkv, S, D, kTile) ||
      !sm90::make_tmap_bf16_3d(&tdv, dv, B * Hkv, S, D, kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = sizeof(Smem<D>) + 1024;  // room to align
  static const cudaError_t attr = cudaFuncSetAttribute(
      dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_kt = (S + kTile - 1) / kTile;
  dkv_kernel<D><<<n_kt * B * Hkv, kThreads, smem, stream>>>(
      tq, tdo, tk, tv, tdk, tdv, static_cast<const float*>(lse),
      static_cast<const float*>(dvec), H, Hkv, S, causal, window, scale,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k3
}  // namespace bwd
}  // namespace tpushare

// Each returns its launch's CUDA error code (0 = launched).
extern "C" int tpushare_flash_bwd_dkv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* dvec,
                                      void* dk, void* dv, int B, int H,
                                      int Hkv, int S, int D, int causal,
                                      int window, float scale, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return tpushare::bwd::k3::launch<64>(q, k, v, dout, lse, dvec, dk, dv,
                                           B, H, Hkv, S, causal, window,
                                           scale, st);
    case 128:
      return tpushare::bwd::k3::launch<128>(q, k, v, dout, lse, dvec, dk, dv,
                                            B, H, Hkv, S, causal, window,
                                            scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int tpushare_flash_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* dvec,
                                     void* dq, int B, int H, int Hkv, int S,
                                     int D, int causal, int window,
                                     float scale, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return tpushare::bwd::k4::launch<64>(q, k, v, dout, lse, dvec, dq, B,
                                           H, Hkv, S, causal, window, scale,
                                           st);
    case 128:
      return tpushare::bwd::k4::launch<128>(q, k, v, dout, lse, dvec, dq, B,
                                            H, Hkv, S, causal, window, scale,
                                            st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
