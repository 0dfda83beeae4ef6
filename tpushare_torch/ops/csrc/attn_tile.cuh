// The warp-level machinery of the paged read (paged_attn.cu; flash_fwd.cu
// and flash_bwd.cu, on sm90.cuh, take only its constants and small
// helpers): a block of 4 warps owns 64 query rows (16 per warp), streams
// keys through shared memory 64 at a time (through a
// loader, so a quantized store can dequantize a tile), and keeps an online
// softmax per row in registers.  Both products run on the tensor cores as
// mma.sync m16n8k16 bf16 x bf16 -> f32; the softmax statistics and the
// output accumulator stay f32.  Key tiles move by cp.async into a ring of
// two shared-memory stages, so the next tile's loads are in flight while
// the current one is folded in.
//
// Numerics follow the TPU kernels in tpushare/ops/attention.py: scores are
// scaled in f32, masked entries take the finite NEG_INF = -1e30, the
// probabilities are rounded to bf16 before the PV product (the sum l uses
// the unrounded f32 values), l is clamped to 1e-30, and lse = m + log(l)
// of the scaled scores.  A masked entry contributes exactly zero (p is
// multiplied by the keep mask), so a fully masked tile seen while m is
// still NEG_INF cannot poison the carry.  The softmax runs in base 2: the
// scores are scaled by scale * log2(e), so each exponential is one
// ex2.approx, and the lse goes back to base e when it is stored.  A tile
// that every row of the block sees whole is folded without the mask.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4*g + t.
//   A (16x16, row):  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16x8, col):   b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C (16x8, f32):   c0,c1 (g, 2t..2t+1)  c2,c3 (g+8, 2t..2t+1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tpushare {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows per block
constexpr int kKeys = 64;           // keys per shared-memory tile

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 in one register: the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 2^x, flushing results below the normal range to zero
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One stage of the ring: a tile of keys, K and V both row-major [key][d].
// The +8 padding breaks the power-of-two row stride (bank conflicts) and
// keeps 16-byte rows for cp.async and ldmatrix.
template <int D>
struct KvStage {
  bf16 k[kKeys][D + 8];
  bf16 v[kKeys][D + 8];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 bytes read: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices: the B fragments of one n-tile for two k-steps
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// four 8x8 b16 matrices, transposed: the B fragments of two n-tiles
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Start the copies of keys [key0, key0 + kKeys) into a stage; keys >=
// key_end are zero-filled.  row_of(key, kp, vp) names the global K and V
// rows of one key (called for keys < key_end only).
template <int D, class RowOf>
__device__ __forceinline__ void copy_tile_async(KvStage<D>& st, int key0,
                                                int key_end, RowOf row_of) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = threadIdx.x; i < kKeys * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const int key = key0 + r;
    const bf16* kp;
    const bf16* vp;
    row_of(min(key, key_end - 1), kp, vp);
    cp_async16(&st.k[r][c], kp + c, key < key_end);
    cp_async16(&st.v[r][c], vp + c, key < key_end);
  }
}

// A warp's 16 query rows: Q fragments, the f32 output accumulator and the
// running max / sum of the two rows (g and g + 8) this lane holds.
template <int D>
struct WarpRows {
  uint32_t q[D / 16][4];
  float acc[D / 8][4];
  float m[2];
  float l[2];
};

// qa / qb: this lane's rows g and g + 8 (nullptr = padding row, reads 0)
template <int D>
__device__ __forceinline__ void init_rows(WarpRows<D>& w, const bf16* qa,
                                          const bf16* qb) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    w.q[kk][0] = qa ? ld32(qa + c) : 0u;
    w.q[kk][1] = qb ? ld32(qb + c) : 0u;
    w.q[kk][2] = qa ? ld32(qa + c + 8) : 0u;
    w.q[kk][3] = qb ? ld32(qb + c + 8) : 0u;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    w.acc[n][0] = w.acc[n][1] = w.acc[n][2] = w.acc[n][3] = 0.f;
  w.m[0] = w.m[1] = kNegInf;
  w.l[0] = w.l[1] = 0.f;
}

// Fold one staged tile into the warp's rows.  keep(half, key) is the mask
// of row g (half 0) or g + 8 (half 1) against an absolute key index; with
// kMasked false every key of the tile is kept and keep is not called.
// scale_log2 = scale * log2(e); the running max m is in those units.
template <int D, bool kMasked, class Keep>
__device__ __forceinline__ void fold_tile(WarpRows<D>& w, const KvStage<D>& sm,
                                          int key0, float scale_log2,
                                          Keep keep) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  float s[kKeys / 8][4];
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    // K rows n*8 + (lane & 7); lanes 8i.. address d-column block i
#pragma unroll
    for (int kk = 0; kk < D / 16; kk += 2) {
      uint32_t b[4];
      ldsm_x4(b, &sm.k[n * 8 + (lane & 7)][kk * 16 + (lane >> 3) * 8]);
      mma16816(s[n], w.q[kk], b[0], b[1]);
      mma16816(s[n], w.q[kk + 1], b[2], b[3]);
    }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = s[n][e] * scale_log2;
      if (kMasked && !keep(e >> 1, key0 + n * 8 + 2 * t + (e & 1)))
        v = kNegInf;
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
  for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2_approx(s[n][e] - m_new[e >> 1]);
      if (kMasked && !keep(e >> 1, key0 + n * 8 + 2 * t + (e & 1))) p = 0.f;
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
  // O += bf16(P) V: the score accumulators of key columns 16kk..16kk+15
  // are exactly the A fragment of P (FlashAttention-2 register reuse)
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
    a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
    a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    // V rows kk*16 + (lane & 15), columns of n-tile n + (lane >> 4)
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, &sm.v[kk * 16 + (lane & 15)][(n + (lane >> 4)) * 8]);
      mma16816(w.acc[n], a, b[0], b[1]);
      mma16816(w.acc[n + 1], a, b[2], b[3]);
    }
  }
}

// A loader is what the key walk asks of a store: copy(stage, key0,
// key_end) starts the cp.async copies of keys [key0, key0 + kKeys) into
// ring stage `stage` (keys >= key_end zero-filled); tile(stage) is called
// by every thread once that stage's copies have landed and been synced,
// and returns the bf16 K/V tile the fold reads.  The bf16 loader copies
// straight into the tile; a quantized store dequantizes in tile().
template <int D, class RowOf>
struct Bf16Loader {
  KvStage<D>* ring;
  RowOf row_of;  // row_of(key, kp, vp): the global K and V rows of a key

  __device__ __forceinline__ void copy(int stage, int key0,
                                       int key_end) const {
    copy_tile_async<D>(ring[stage], key0, key_end, row_of);
  }
  __device__ __forceinline__ const KvStage<D>& tile(int stage) const {
    return ring[stage];
  }
};

// The key walk of one block over [key_begin, key_end) (uniform across the
// block): tile i + 1 is copied into the other stage while tile i is folded
// into the warps' rows.  Warps without live rows still copy and sync.
// whole(key0) is true when every row of the block keeps every key of the
// tile at key0 (the tile is folded without the mask).
template <int D, class Loader, class Keep, class Whole>
__device__ __forceinline__ void walk_tiles(WarpRows<D>& w, const Loader& ld,
                                           int key_begin, int key_end,
                                           float scale, bool live, Keep keep,
                                           Whole whole) {
  if (key_begin >= key_end) return;
  const float scale_log2 = scale * kLog2e;
  ld.copy(0, key_begin, key_end);
  cp_async_commit();
  int stage = 0;
  for (int key0 = key_begin; key0 < key_end; key0 += kKeys) {
    if (key0 + kKeys < key_end) {
      ld.copy(stage ^ 1, key0 + kKeys, key_end);
      cp_async_commit();
      cp_async_wait<1>();  // this thread's copies of tile key0 landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();       // ... and everyone else's
    const KvStage<D>& t = ld.tile(stage);
    if (live) {
      if (whole(key0))
        fold_tile<D, false>(w, t, key0, scale_log2, keep);
      else
        fold_tile<D, true>(w, t, key0, scale_log2, keep);
    }
    __syncthreads();       // the stage is free for the copy after next
    stage ^= 1;
  }
}

// walk_tiles over bf16 K/V rows named by row_of(key, kp, vp)
template <int D, class RowOf, class Keep, class Whole>
__device__ __forceinline__ void walk_keys(WarpRows<D>& w, KvStage<D>* st,
                                          int key_begin, int key_end,
                                          float scale, bool live,
                                          RowOf row_of, Keep keep,
                                          Whole whole) {
  walk_tiles<D>(w, Bf16Loader<D, RowOf>{st, row_of}, key_begin, key_end,
                scale, live, keep, whole);
}

// dynamic shared memory of the two-stage ring
template <int D>
__host__ __device__ constexpr size_t ring_bytes() {
  return 2 * sizeof(KvStage<D>);
}

// out = acc / max(l, 1e-30) in bf16; lse = m + log(max(l, 1e-30)) in f32,
// with m taken back from base-2 units.
// Null pointers skip a padding row (or the lse output).
template <int D>
__device__ __forceinline__ void store_rows(const WarpRows<D>& w, bf16* oa,
                                           bf16* ob, float* lse_a,
                                           float* lse_b) {
  const int t = threadIdx.x & 3;
  const float la = fmaxf(w.l[0], 1e-30f);
  const float lb = fmaxf(w.l[1], 1e-30f);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (oa)
      *reinterpret_cast<uint32_t*>(oa + c) =
          pack_bf16x2(w.acc[n][0] / la, w.acc[n][1] / la);
    if (ob)
      *reinterpret_cast<uint32_t*>(ob + c) =
          pack_bf16x2(w.acc[n][2] / lb, w.acc[n][3] / lb);
  }
  if (t == 0) {
    // a row that kept no key has m = NEG_INF, as in base e
    if (lse_a) *lse_a = (w.m[0] > kNegInf ? w.m[0] * kLn2 : kNegInf) + logf(la);
    if (lse_b) *lse_b = (w.m[1] > kNegInf ? w.m[1] * kLn2 : kNegInf) + logf(lb);
  }
}

}  // namespace tpushare

extern "C" const char* tpushare_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
