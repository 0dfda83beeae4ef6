// The mma.sync machinery of K2's decode arm (paged_decode.cu; flash_fwd.cu,
// flash_bwd.cu and paged_attn.cu, on sm90.cuh, take only its constants
// and small helpers): warps of 16 query rows holding their Q fragments,
// f32 output accumulator and online-softmax state in registers
// (WarpRows), mma.sync m16n8k16 bf16 x bf16 -> f32, ldmatrix fragment
// loads, and key tiles of 64 copied by cp.async into padded shared-memory
// stages (KvStage), through a loader so that a quantized store can
// dequantize a tile.
//
// Numerics follow the TPU kernels in tpushare/ops/attention.py: scores are
// scaled in f32, masked entries take the finite NEG_INF = -1e30, the
// probabilities are rounded to bf16 before the PV product (the sum l uses
// the unrounded f32 values), l is clamped to 1e-30.  A masked entry
// contributes exactly zero (p is multiplied by the keep mask), so a fully
// masked tile seen while m is still NEG_INF cannot poison the carry.  The
// softmax runs in base 2: the scores are scaled by scale * log2(e), so
// each exponential is one ex2.approx.
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

// A loader is what a key walk asks of a store: copy(stage, key0,
// key_end) starts the cp.async copies of keys [key0, key0 + kKeys) into
// ring stage `stage` (keys >= key_end zero-filled); tile(stage) is called
// by every thread once that stage's copies have landed and been synced,
// and returns the tile the fold reads.  The bf16 loader copies straight
// into the tile.
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

}  // namespace tpushare

extern "C" const char* tpushare_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
