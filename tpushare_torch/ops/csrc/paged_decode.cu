// K2's decode arm: the paged-pool read at S = 1, split over the page table,
// for Hopper (sm_90a).
//
// Replaces tpushare/ops/attention.py::_paged_attn_kernel (the Pallas TPU
// kernel launched by paged_decode_attention) for every decode step: the
// bf16 store and the int8 store (the body's :664-692), each also in its
// striped variant (with_pos_map + with_stats, :662, :699, :722-724).  A
// call with S > 1 (a prefill window, a chunk) goes to paged_attn.cu.
//
// Bound on an H100: bytes.  A decode step reads every live K/V page once
// and does ~2 * n_rep FLOP per element read.  The TPU walked a row's whole
// table as one sequential grid axis; paged_attn.cu does the same walk in
// one block per (kv head, batch row), so at 8 rows x 8 kv heads 64 blocks
// hold 132 SMs and the longest row sets the time.  Here the table is cut
// into splits of split_pages entries (chosen on the host from page and
// n_tbl alone: no position is read back), and the work is the items
// (row b, split c, kv head kh) whose split holds a key the row keeps:
// every block reads the rows' positions, counts each row's non-empty
// splits (a window's leading ones and those after the position are
// empty) and walks items blockIdx.x, + gridDim.x, ... over a grid of as
// many blocks as the card holds at once.  (A grid of every (split, kv
// head, row) spent ~60% of a decode call scheduling blocks with nothing
// to read: 1,760 of 2,048 at the serving shape.)  An item folds its keys
// for the n_rep q heads of kv head kh and writes its f32 partials (o =
// acc / l, m in base e, l) to a workspace [B * H, n_splits, D + 2].
//
// Inside a block every warp works on the keys: at decode the n_rep <= 16
// q heads of a kv head fit one 16-row mma tile, so the 4 warps take
// disjoint 16-key subtiles of each 64-key tile (n_rep up to 32 or 64:
// two or four row groups, and fewer key groups), each keeping its own
// online softmax (m, l, acc) in registers, and the warps' states are
// merged through shared memory at the end of the split.  The fold has the
// numerics of attn_tile.cuh's (f32 scaled scores, p times the keep mask,
// P rounded to bf16 before PV).  Tiles stream through a ring of cp.async
// stages: two for the bf16 pool (a third, 104 KB a block at D = 128,
// fits two blocks an SM instead of three and took 25% longer); three for
// the int8 store, whose stages the fold reads as they are: the mma B
// fragments are built in registers from the int8 bytes and their keys'
// scales, each element bf16(f32(q) * s) as the TPU body rounds it, with
// no bf16 tile in shared memory and no barrier to fill one.
//
// The combine is the split kernel's own tail: each item takes a ticket
// from a per-(b, kh) counter once its partials are out (__threadfence
// first), and the item that draws the row's last ticket folds its
// splits as sp_merge_partials does (M = max m, w = exp(m - M) * l, out =
// sum w * o / max(sum w, 1e-30)), writes bf16 out (and, striped, the
// stripe's m = M and l = sum w for the cross-stripe merge), and resets
// the counter to 0 for the next launch.  A second kernel would add one
// device operation a layer to a decode step that is already host-bound.
//
// A key's position is (pos_map ? pos_map[j] : j * page) + lane for table
// entry j: the striped variant (kStriped) stages its split's pos_map
// entries beside the table.  A subtile inside every row's range is folded
// without the mask.  Splits start at multiples of 64 keys, so tiles stay
// 64-aligned in walk index (the int8 loader's four-scale chunks).
#include <algorithm>
#include <climits>

#include "paged_pool.cuh"

namespace tpushare {

// keys a warp folds at a time: one k-step of the PV product
constexpr int kSubKeys = 16;

// One ring stage of the int8 store for the decode arm: a tile's raw K and
// V rows (16 bytes of padding a row, so the fragment loads of a warp's 8
// keys fall in 8 different banks) and their per-key scales.
template <int D>
struct Int8Tile {
  int8_t k[kKeys][D + 16];
  int8_t v[kKeys][D + 16];
  float ks[kKeys];
  float vs[kKeys];
};

// The int8 store's loader for the decode arm: cp.async copies of a tile's
// int8 rows and scales into a stage (paged_pool.cuh's copy_int8_tile),
// and the fold reads the stage itself: no bf16 tile, no barrier of its
// own.
template <int D, class Slot>
struct Int8RegLoader {
  Int8Tile<D>* ring;
  Slot slot;
  const int8_t* kq;
  const float* ks;
  const int8_t* vq;
  const float* vs;

  __device__ __forceinline__ void copy(int stage, int key0,
                                       int key_end) const {
    copy_int8_tile<D>(ring[stage], slot, kq, ks, vq, vs, key0, key_end);
  }
  __device__ __forceinline__ const Int8Tile<D>& tile(int stage) const {
    return ring[stage];
  }
};

// The decode arm's shared memory a store: its ring of kStages stages, two
// bf16 stages (69.6 KB at D = 128, three blocks an SM) or three int8
// stages (56.8 KB).
template <class Pool>
struct DecodeRing;

template <>
struct DecodeRing<Bf16Pool> {
  static constexpr int kStages = 2;
  template <int D>
  __host__ __device__ static constexpr size_t bytes() {
    return kStages * sizeof(KvStage<D>);
  }
  template <int D, class Slot>
  __device__ __forceinline__ static auto loader(const Bf16Pool& p,
                                                unsigned char* smem,
                                                Slot slot) {
    return p.template loader<D>(smem, slot);
  }
};

template <>
struct DecodeRing<Int8Pool> {
  static constexpr int kStages = 3;
  template <int D>
  __host__ __device__ static constexpr size_t bytes() {
    return kStages * sizeof(Int8Tile<D>);
  }
  template <int D, class Slot>
  __device__ __forceinline__ static Int8RegLoader<D, Slot> loader(
      const Int8Pool& p, unsigned char* smem, Slot slot) {
    return Int8RegLoader<D, Slot>{reinterpret_cast<Int8Tile<D>*>(smem),
                                  slot, p.kq, p.ks, p.vq, p.vs};
  }
};

// The B fragments of K for keys kb + 8n .. + 7 and k-steps kk, kk + 1
// (mma.m16n8k16: b0/b1 of a step hold d 2t, 2t + 1 and 2t + 8, 2t + 9 of
// key g): from a bf16 tile by ldmatrix; from an int8 stage by two bytes
// of one key times its scale, each element bf16(f32(q) * s) as the TPU
// body rounds it.
template <int D>
__device__ __forceinline__ void k_frags(uint32_t b[4], const KvStage<D>& st,
                                        int kb, int kk) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, &st.k[kb + (lane & 7)][kk * 16 + (lane >> 3) * 8]);
}

template <int D>
__device__ __forceinline__ void k_frags(uint32_t b[4], const Int8Tile<D>& st,
                                        int kb, int kk) {
  const int lane = threadIdx.x & 31;
  const int key = kb + (lane >> 2);
  const float s = st.ks[key];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const char2 x = *reinterpret_cast<const char2*>(
        &st.k[key][kk * 16 + i * 8 + 2 * (lane & 3)]);
    b[i] = pack_bf16x2(__fmul_rn(static_cast<float>(x.x), s),
                       __fmul_rn(static_cast<float>(x.y), s));
  }
}

// The B fragments of V for keys kb .. kb + 15 and d-tiles n, n + 1 (b0/b1
// of a tile hold keys 2t, 2t + 1 and 2t + 8, 2t + 9 at d = 8n + g): by
// ldmatrix.trans from a bf16 tile; from an int8 stage by one byte of each
// of two keys times its own scale.
template <int D>
__device__ __forceinline__ void v_frags(uint32_t b[4], const KvStage<D>& st,
                                        int kb, int n) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(b, &st.v[kb + (lane & 15)][(n + (lane >> 4)) * 8]);
}

template <int D>
__device__ __forceinline__ void v_frags(uint32_t b[4], const Int8Tile<D>& st,
                                        int kb, int n) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = kb + (i & 1) * 8 + 2 * (lane & 3);
    const int d = (n + (i >> 1)) * 8 + (lane >> 2);
    b[i] = pack_bf16x2(
        __fmul_rn(static_cast<float>(st.v[key][d]), st.vs[key]),
        __fmul_rn(static_cast<float>(st.v[key + 1][d]), st.vs[key + 1]));
  }
}

// Fold keys kb .. kb + 15 of a staged tile (walk keys k0 ..) into one
// warp's rows: an online-softmax fold of a 16-key subtile on mma.sync,
// with K2's numerics (f32 scores in base 2, p times the keep mask, P
// rounded to bf16 before PV).  keep(key) is the mask of every row of the block
// (they share one position); with kMasked false it is not called.
template <int D, bool kMasked, class Tile, class Keep>
__device__ __forceinline__ void fold_sub(WarpRows<D>& w, const Tile& sm,
                                         int kb, int k0, float scale_log2,
                                         Keep keep) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  float s[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; kk += 2) {
      uint32_t b[4];
      k_frags<D>(b, sm, kb + n * 8, kk);
      mma16816(s[n], w.q[kk], b[0], b[1]);
      mma16816(s[n], w.q[kk + 1], b[2], b[3]);
    }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = s[n][e] * scale_log2;
      if (kMasked && !keep(k0 + n * 8 + 2 * t + (e & 1))) v = kNegInf;
      s[n][e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
  }
  float alpha[2], m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    m_new[h] = fmaxf(w.m[h], mx[h]);
    alpha[h] = exp2_approx(w.m[h] - m_new[h]);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2_approx(s[n][e] - m_new[e >> 1]);
      if (kMasked && !keep(k0 + n * 8 + 2 * t + (e & 1))) p = 0.f;
      s[n][e] = p;
      sum[e >> 1] += p;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    w.l[h] = w.l[h] * alpha[h] + sum[h];
    w.m[h] = m_new[h];
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    w.acc[n][0] *= alpha[0];
    w.acc[n][1] *= alpha[0];
    w.acc[n][2] *= alpha[1];
    w.acc[n][3] *= alpha[1];
  }
  // the score accumulators of the 16 keys are the A fragment of P
  uint32_t a[4];
  a[0] = pack_bf16x2(s[0][0], s[0][1]);
  a[1] = pack_bf16x2(s[0][2], s[0][3]);
  a[2] = pack_bf16x2(s[1][0], s[1][1]);
  a[3] = pack_bf16x2(s[1][2], s[1][3]);
#pragma unroll
  for (int n = 0; n < D / 8; n += 2) {
    uint32_t b[4];
    v_frags<D>(b, sm, kb, n);
    mma16816(w.acc[n], a, b[0], b[1]);
    mma16816(w.acc[n + 1], a, b[2], b[3]);
  }
}

// The walk of one split's keys [key_begin, key_end) (key_begin a multiple
// of kKeys): tiles stream through a ring of kStages stages (kStages - 1
// tiles in flight while one is folded), and warp w folds subtiles kg,
// kg + n_kg, ... of every tile into its own rows' state.
template <int D, int kStages, class Loader, class Keep, class Whole>
__device__ __forceinline__ void walk_split(WarpRows<D>& w, const Loader& ld,
                                           int key_begin, int key_end,
                                           float scale, int kg, int n_kg,
                                           Keep keep, Whole whole) {
  const float scale_log2 = scale * kLog2e;
  const int n_tiles = (key_end - key_begin + kKeys - 1) / kKeys;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) ld.copy(i, key_begin + i * kKeys, key_end);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int next = t + kStages - 1;
    if (next < n_tiles)
      ld.copy(next % kStages, key_begin + next * kKeys, key_end);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this thread's copies of tile t landed
    __syncthreads();               // ... and everyone else's
    const auto& st = ld.tile(t % kStages);
    const int key0 = key_begin + t * kKeys;
    for (int sub = kg; sub < kKeys / kSubKeys; sub += n_kg) {
      const int k0 = key0 + sub * kSubKeys;
      if (k0 >= key_end) break;
      if (whole(k0))
        fold_sub<D, false>(w, st, sub * kSubKeys, k0, scale_log2, keep);
      else
        fold_sub<D, true>(w, st, sub * kSubKeys, k0, scale_log2, keep);
    }
    __syncthreads();  // the stage is free for the copy kStages - 1 on
  }
}

// One item of the grid's work: split c of row b for kv head kh, keys
// [key_begin, key_end) of the walk (non-empty).  Folds them with every warp
// on the keys, writes the split's f32 partials (o = acc / l, m in base e,
// l) to the workspace, takes the row's ticket, and if it is the last of
// the row's n_c splits (c_lo ..) folds them into out (and, striped, the
// stripe's m and l), then leaves the ticket at 0 for the next launch.
template <int D, class Pool, bool kStriped>
__device__ __forceinline__ void decode_item(
    unsigned char* smem, const bf16* q, const Pool& pool, const int* tbl_b,
    const int* pos_map, bf16* o, float* m_out, float* l_out, float* ws_o,
    float* ws_m, float* ws_l, unsigned* ticket_b, unsigned& ticket,
    size_t row0, int n_rep, int kh, int Hkv, int page, int split_pages,
    int n_split, int c, int c_lo, int n_c, int pos, int key_begin,
    int key_end, int window, float scale) {
  int* tbl_s = reinterpret_cast<int*>(
      smem + DecodeRing<Pool>::template bytes<D>());  // [split_pages]
  int* pos_s = tbl_s + split_pages;  // [split_pages], kStriped
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j0 = c * split_pages;
  key_begin = key_begin / kKeys * kKeys;  // >= j0 * page, a multiple
  for (int j = key_begin / page + threadIdx.x; j <= (key_end - 1) / page;
       j += kThreads) {
    tbl_s[j - j0] = tbl_b[j];
    if constexpr (kStriped) pos_s[j - j0] = pos_map[j];
  }
  __syncthreads();

  // The n_rep q heads ride n_rg = ceil(n_rep / 16) row groups of 16 (rows
  // past n_rep are padding: zero queries, never stored); the block's 4
  // warps are n_rg row groups x n_kg key groups, and warp w folds row
  // group w % n_rg over subtiles w / n_rg, + n_kg, ... of every tile,
  // with its own (m, l, acc).
  const int n_rg = n_rep <= 16 ? 1 : n_rep <= 32 ? 2 : kWarps;
  const int n_kg = kWarps / n_rg;
  const int ra = warp % n_rg * 16 + (lane >> 2);
  const int rb = ra + 8;
  WarpRows<D> w;
  init_rows<D>(w, ra < n_rep ? q + (row0 + ra) * D : nullptr,
               rb < n_rep ? q + (row0 + rb) * D : nullptr);
  // the row of a key in the pool's [n_pages * Hkv * page] rows
  auto slot = [=](int key) {
    return (static_cast<size_t>(tbl_s[key / page - j0]) * Hkv + kh) * page +
           key % page;
  };
  // a walk key's position (they increase along the walk)
  auto kpos = [=](int key) {
    if constexpr (kStriped)
      return pos_s[key / page - j0] + key % page;
    else
      return key;
  };
  auto keep = [=](int key) {
    return key < key_end && kpos(key) <= pos &&
           (window <= 0 || kpos(key) > pos - window);
  };
  // every row sits at pos: a subtile is kept whole when its last key is
  // at or before pos and its first inside the window
  auto whole = [=](int k0) {
    return k0 + kSubKeys <= key_end && kpos(k0 + kSubKeys - 1) <= pos &&
           (window <= 0 || kpos(k0) > pos - window);
  };
  walk_split<D, DecodeRing<Pool>::kStages>(
      w, DecodeRing<Pool>::template loader<D>(pool, smem, slot), key_begin,
      key_end, scale, warp / n_rg, n_kg, keep, whole);

  // the warps' states through shared memory (the ring is free: the walk
  // ended on a barrier with no copy in flight): [kWarps][16][D + 2] f32,
  // acc then m (base 2) and l of each of a warp's 16 rows
  static_assert(kWarps * 16 * (D + 2) * sizeof(float) <=
                    DecodeRing<Pool>::template bytes<D>(),
                "the warps' states fit the ring");
  float* merge = reinterpret_cast<float*>(smem);
  {
    const int g = lane >> 2;
    const int t = lane & 3;
    float* ma = merge + (warp * 16 + g) * (D + 2);
    float* mb = ma + 8 * (D + 2);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(ma + n * 8 + 2 * t) =
          make_float2(w.acc[n][0], w.acc[n][1]);
      *reinterpret_cast<float2*>(mb + n * 8 + 2 * t) =
          make_float2(w.acc[n][2], w.acc[n][3]);
    }
    if (t == 0) {
      ma[D] = w.m[0];
      ma[D + 1] = w.l[0];
      mb[D] = w.m[1];
      mb[D + 1] = w.l[1];
    }
  }
  __syncthreads();
  // this split's partials: o = sum_w 2^(m_w - M) acc_w / L (f32), m = M
  // back in base e, L = sum_w 2^(m_w - M) l_w unclamped (a warp that kept
  // no key has m_w = NEG_INF and l_w = 0); a row's only split writes them
  // as its output instead
  for (int i = threadIdx.x; i < n_rep * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    const float* row = merge + r * (D + 2);  // warp r / 16's row r % 16
    float mx = kNegInf;
    for (int k = 0; k < n_kg; ++k)
      mx = fmaxf(mx, row[k * n_rg * 16 * (D + 2) + D]);
    float sum = 0.f, acc = 0.f;
    for (int k = 0; k < n_kg; ++k) {
      const float* src = row + k * n_rg * 16 * (D + 2);
      const float a = exp2_approx(src[D] - mx);
      sum += a * src[D + 1];
      acc += a * src[d];
    }
    const float m = mx > kNegInf ? mx * kLn2 : kNegInf;
    if (n_c == 1) {
      o[(row0 + r) * D + d] = __float2bfloat16_rn(acc / fmaxf(sum, 1e-30f));
      if (kStriped && d == 0) {
        m_out[row0 + r] = m;
        l_out[row0 + r] = sum;
      }
      continue;
    }
    const size_t at = (row0 + r) * n_split + c;
    ws_o[at * D + d] = acc / fmaxf(sum, 1e-30f);
    if (d == 0) {
      ws_m[at] = m;
      ws_l[at] = sum;
    }
  }
  if (n_c == 1) return;

  // the ticket: the block that finishes the row's last split folds them
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(ticket_b, 1u);
  __syncthreads();
  if (ticket != static_cast<unsigned>(n_c - 1)) return;
  __threadfence();
  if (threadIdx.x == 0) *ticket_b = 0u;

  // one warp a q head; each lane D / 32 consecutive columns.  Partials of
  // other blocks are read through L2 (__ldcg), never a stale L1 line.
  constexpr int kCols = D / 32;
  for (int r = warp; r < n_rep; r += kWarps) {
    const size_t at = (row0 + r) * n_split;
    float mx = kNegInf;
    for (int s = c_lo + lane; s < c_lo + n_c; s += 32)
      mx = fmaxf(mx, __ldcg(ws_m + at + s));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float acc[kCols] = {};
    float sum = 0.f;
    for (int s = c_lo; s < c_lo + n_c; ++s) {
      const float wgt = expf(__ldcg(ws_m + at + s) - mx) *
                        __ldcg(ws_l + at + s);
      sum += wgt;
      const float* src = ws_o + (at + s) * D + lane * kCols;
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] += wgt * __ldcg(src + i);
    }
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    bf16* dst = o + (row0 + r) * D + lane * kCols;
#pragma unroll
    for (int i = 0; i < kCols; i += 2)
      *reinterpret_cast<uint32_t*>(dst + i) =
          pack_bf16x2(acc[i] * inv, acc[i + 1] * inv);
    if constexpr (kStriped) {
      if (lane == 0) {
        m_out[row0 + r] = mx;
        l_out[row0 + r] = sum;
      }
    }
  }
}

// The grid is the card's resident blocks (or fewer), each walking items
// blockIdx.x, + gridDim.x, ...: a row's non-empty splits times the kv
// heads, enumerated by every block from the positions.  Row b keeps walk
// keys [lo, end): unstriped, positions max(0, pos - window + 1) .. pos;
// striped, the entries from the first inside the window to the last
// starting at or before pos (binary searches: pos_map increases).  Its
// non-empty splits are c_lo .. c_lo + n_c - 1, so no block walks an empty
// split; a row with none (a stripe whose keys all lie after its position)
// gets out 0, m NEG_INF and l 0 from block b % gridDim.x.
template <int D, class Pool, bool kStriped>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const bf16* __restrict__ q, const Pool pool,
                        const int* __restrict__ table,
                        const int* __restrict__ pos_map,
                        const int* __restrict__ positions,
                        bf16* __restrict__ o, float* __restrict__ m_out,
                        float* __restrict__ l_out, float* __restrict__ ws,
                        unsigned* __restrict__ tickets, int B, int H,
                        int Hkv, int page, int n_tbl, int split_pages,
                        int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  // after the ring and the split's table (and pos_map): each row's kept
  // walk keys [lo, end) and the prefix sums of its non-empty splits
  int* row_lo = reinterpret_cast<int*>(
      smem + DecodeRing<Pool>::template bytes<D>()) +
      (kStriped ? 2 : 1) * split_pages;
  int* row_end = row_lo + B;
  int* row_off = row_end + B;  // [B + 1]
  __shared__ unsigned ticket;
  const int n_rep = H / Hkv;
  const int keys = split_pages * page;
  const int n_split = (n_tbl + split_pages - 1) / split_pages;

  for (int b = threadIdx.x; b < B; b += kThreads) {
    const int pos = positions[b];
    int lo, end;
    if constexpr (kStriped) {
      // entries starting at or before pos; entries wholly behind the
      // window (their last position <= pos - window)
      auto count = [&](int bound) {
        int n = 0, hi = n_tbl;
        while (n < hi) {
          const int mid = (n + hi) / 2;
          if (pos_map[mid] <= bound) n = mid + 1; else hi = mid;
        }
        return n;
      };
      end = count(pos) * page;
      lo = window > 0 ? count(pos - window - page + 1) * page : 0;
    } else {
      end = min(pos + 1, n_tbl * page);
      lo = window > 0 ? max(pos - window + 1, 0) : 0;
    }
    row_lo[b] = lo;
    row_end[b] = end;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int off = 0;
    for (int b = 0; b < B; ++b) {
      row_off[b] = off;
      if (row_lo[b] < row_end[b])
        off += (row_end[b] - 1) / keys - row_lo[b] / keys + 1;
    }
    row_off[B] = off;
  }
  __syncthreads();

  // rows with no kept key: out 0 (and m NEG_INF, l 0)
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    if (row_off[b + 1] != row_off[b]) continue;
    for (int i = threadIdx.x; i < H * D / 2; i += kThreads)
      reinterpret_cast<uint32_t*>(o + static_cast<size_t>(b) * H * D)[i] =
          0u;
    if constexpr (kStriped)
      for (int h = threadIdx.x; h < H; h += kThreads) {
        m_out[static_cast<size_t>(b) * H + h] = kNegInf;
        l_out[static_cast<size_t>(b) * H + h] = 0.f;
      }
  }

  const size_t n_rows = static_cast<size_t>(B) * H;
  float* ws_o = ws;
  float* ws_m = ws + n_rows * n_split * D;
  float* ws_l = ws_m + n_rows * n_split;
  const int n_items = row_off[B] * Hkv;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int u = item / Hkv;
    const int kh = item % Hkv;
    int b = 0;
    while (row_off[b + 1] <= u) ++b;
    const int lo = row_lo[b], end = row_end[b];
    const int c_lo = lo / keys;
    const int c = c_lo + u - row_off[b];
    decode_item<D, Pool, kStriped>(
        smem, q, pool, table + static_cast<size_t>(b) * n_tbl, pos_map, o,
        m_out, l_out, ws_o, ws_m, ws_l,
        tickets + static_cast<size_t>(b) * Hkv + kh, ticket,
        static_cast<size_t>(b) * H + kh * n_rep, n_rep, kh, Hkv, page,
        split_pages, n_split, c, c_lo, row_off[b + 1] - row_off[b],
        positions[b], max(c * keys, lo), min((c + 1) * keys, end), window,
        scale);
    __syncthreads();  // the shared memory is the next item's
  }
}

// what a launch takes besides the pool
struct Args {
  const void* q;
  const void* table;
  const void* pos_map;  // kStriped only
  const void* positions;
  void* o;
  void* m;  // kStriped only
  void* l;  // kStriped only
  void* ws;
  void* tickets;
  int B, H, Hkv, D, page, n_tbl, split_pages, window;
  float scale;
};

template <int D, bool kStriped, class Pool>
static void launch(const Pool& pool, const Args& a, cudaStream_t stream) {
  const auto kernel = paged_decode_kernel<D, Pool, kStriped>;
  const int n_split = (a.n_tbl + a.split_pages - 1) / a.split_pages;
  const size_t smem = DecodeRing<Pool>::template bytes<D>() +
                      sizeof(int) * ((kStriped ? 2 : 1) * a.split_pages +
                                     3 * a.B + 1);
  // as many blocks as the card holds at once (every item is at most one
  // split's keys), never more than there could be items; the attribute
  // and the occupancy are asked once a (device, shared memory size) and
  // host thread, off the per-step launch path
  static thread_local int cached_dev = -1;
  static thread_local size_t cached_smem = 0;
  static thread_local int resident = 1;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != cached_dev || smem != cached_smem) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  smem);
    resident = std::max(sms * per_sm, 1);
    cached_dev = dev;
    cached_smem = smem;
  }
  const long long items = static_cast<long long>(a.B) * a.Hkv * n_split;
  const int grid = static_cast<int>(std::max(
      1LL, std::min(items, static_cast<long long>(resident))));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(a.q), pool, static_cast<const int*>(a.table),
      static_cast<const int*>(a.pos_map),
      static_cast<const int*>(a.positions), static_cast<bf16*>(a.o),
      static_cast<float*>(a.m), static_cast<float*>(a.l),
      static_cast<float*>(a.ws), static_cast<unsigned*>(a.tickets), a.B,
      a.H, a.Hkv, a.page, a.n_tbl, a.split_pages, a.window, a.scale);
}

template <bool kStriped, class Pool>
static int dispatch(const Pool& pool, const Args& a, void* stream) {
  // n_rep rows ride the block's 4 warps of 16; a split starts at a
  // multiple of the 64-key tile
  if (a.B < 1 || a.Hkv < 1 || a.H % a.Hkv != 0 || a.H / a.Hkv > kRows ||
      a.page < 1 || a.n_tbl < 1 || a.split_pages < 1 ||
      (a.split_pages * a.page) % kKeys != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a.D) {
    case 64:
      launch<64, kStriped>(pool, a, st);
      break;
    case 128:
      launch<128, kStriped>(pool, a, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tpushare

// Each entry point returns cudaGetLastError() after the launch (0 =
// launched).  q [B, H, 1, D] bf16 at positions [B, 1]; table [B, n_tbl];
// ws f32 [B * H * n_splits * (D + 2)] with n_splits = ceil(n_tbl /
// split_pages); tickets u32 [B * Hkv], all 0 (the kernel leaves them 0).
extern "C" int tpushare_paged_decode(const void* q, const void* kpool,
                                     const void* vpool, const void* table,
                                     const void* positions, void* o,
                                     void* ws, void* tickets, int B, int H,
                                     int Hkv, int D, int page, int n_tbl,
                                     int split_pages, int window,
                                     float scale, void* stream) {
  const tpushare::Bf16Pool pool{static_cast<const tpushare::bf16*>(kpool),
                                static_cast<const tpushare::bf16*>(vpool)};
  return tpushare::dispatch<false>(
      pool, {q, table, nullptr, positions, o, nullptr, nullptr, ws, tickets,
             B, H, Hkv, D, page, n_tbl, split_pages, window, scale},
      stream);
}

// The int8 store: kq/vq int8 [n_pages, Hkv, page, D], ks/vs f32 [n_pages,
// Hkv, page, 1], all 16-byte aligned; page % 4 == 0.
extern "C" int tpushare_paged_decode_int8(
    const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* table, const void* positions, void* o,
    void* ws, void* tickets, int B, int H, int Hkv, int D, int page,
    int n_tbl, int split_pages, int window, float scale, void* stream) {
  if (page % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return tpushare::dispatch<false>(
      tpushare::int8_pool(kq, ks, vq, vs),
      {q, table, nullptr, positions, o, nullptr, nullptr, ws, tickets, B, H,
       Hkv, D, page, n_tbl, split_pages, window, scale},
      stream);
}

// The striped variants: pos_map int32 [n_tbl] (increasing) gives each
// table entry's starting position; m and l f32 [B, H, 1] receive the
// stripe's softmax partials.
extern "C" int tpushare_paged_decode_striped(
    const void* q, const void* kpool, const void* vpool, const void* table,
    const void* pos_map, const void* positions, void* o, void* m, void* l,
    void* ws, void* tickets, int B, int H, int Hkv, int D, int page,
    int n_tbl, int split_pages, int window, float scale, void* stream) {
  const tpushare::Bf16Pool pool{static_cast<const tpushare::bf16*>(kpool),
                                static_cast<const tpushare::bf16*>(vpool)};
  return tpushare::dispatch<true>(
      pool, {q, table, pos_map, positions, o, m, l, ws, tickets, B, H, Hkv,
             D, page, n_tbl, split_pages, window, scale},
      stream);
}

extern "C" int tpushare_paged_decode_int8_striped(
    const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* table, const void* pos_map,
    const void* positions, void* o, void* m, void* l, void* ws,
    void* tickets, int B, int H, int Hkv, int D, int page, int n_tbl,
    int split_pages, int window, float scale, void* stream) {
  if (page % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return tpushare::dispatch<true>(
      tpushare::int8_pool(kq, ks, vq, vs),
      {q, table, pos_map, positions, o, m, l, ws, tickets, B, H, Hkv, D,
       page, n_tbl, split_pages, window, scale},
      stream);
}
