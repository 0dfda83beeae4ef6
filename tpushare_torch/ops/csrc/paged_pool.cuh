// The paged pool's stores, shared by K2's two arms: paged_attn.cu (S > 1)
// and paged_decode.cu (S = 1, split over the page table).  The bf16 pool
// hands the decode arm attn_tile.cuh's loader (a 64-key tile copied
// straight into a ring stage); the int8 store {"q": int8 [n_pages, Hkv,
// page, D], "s": f32 [n_pages, Hkv, page, 1]} is copied as raw int8 rows
// and their scales (16-byte cp.async chunks: four scales a chunk, so page
// % 4 == 0 and tiles start at multiples of 4 keys) and dequantized, each
// element bf16(f32(q) * s) as the TPU body rounds it (dequant8).
#pragma once

#include <climits>

#include "attn_tile.cuh"

namespace tpushare {

// one layer's bf16 pool
struct Bf16Pool {
  const bf16* k;
  const bf16* v;

  // slot(key): the row index of a key in [n_pages * Hkv * page]
  template <int D, class Slot>
  __device__ __forceinline__ auto loader(unsigned char* smem,
                                         Slot slot) const {
    const bf16* kb = k;
    const bf16* vb = v;
    auto row_of = [=](int key, const bf16*& kp, const bf16*& vp) {
      const size_t off = slot(key) * D;
      kp = kb + off;
      vp = vb + off;
    };
    return Bf16Loader<D, decltype(row_of)>{
        reinterpret_cast<KvStage<D>*>(smem), row_of};
  }
};

// eight int8 values times their key's scale -> eight bf16 (16 bytes).
// Each byte becomes a float without the (quarter-rate) integer
// conversion: its sign bit flipped, placed under the exponent of 2^23,
// it reads 2^23 + 128 + q, and one exact subtraction leaves f32(q).
__device__ __forceinline__ float s8_lane(uint32_t biased, int i) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 | i)) -
         8388736.f;
}

__device__ __forceinline__ void dequant8(bf16* dst, const int8_t* src,
                                         float s) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const uint32_t lo = raw.x ^ 0x80808080u, hi = raw.y ^ 0x80808080u;
  uint4 out;
  out.x = pack_bf16x2(__fmul_rn(s8_lane(lo, 0), s),
                      __fmul_rn(s8_lane(lo, 1), s));
  out.y = pack_bf16x2(__fmul_rn(s8_lane(lo, 2), s),
                      __fmul_rn(s8_lane(lo, 3), s));
  out.z = pack_bf16x2(__fmul_rn(s8_lane(hi, 0), s),
                      __fmul_rn(s8_lane(hi, 1), s));
  out.w = pack_bf16x2(__fmul_rn(s8_lane(hi, 2), s),
                      __fmul_rn(s8_lane(hi, 3), s));
  *reinterpret_cast<uint4*>(dst) = out;
}

// cp.async copies of the int8 store's keys [key0, min(key0 + kKeys,
// key_end)) into a ring stage: any Stage with rows k[kKeys][>= D] and
// v[kKeys][>= D] and scales ks[kKeys] and vs[kKeys] (paged_decode.cu's
// padded rows), 16-byte chunks of each row and four scales a chunk.
template <int D, class Stage, class Slot>
__device__ __forceinline__ void copy_int8_tile(
    Stage& st, const Slot& slot, const int8_t* kq, const float* ks,
    const int8_t* vq, const float* vs, int key0, int key_end) {
  constexpr int kChunks = D / 16;  // 16-byte chunks per int8 row
#pragma unroll
  for (int i = threadIdx.x; i < kKeys * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 16;
    const int key = key0 + r;
    const size_t off = slot(min(key, key_end - 1)) * D + c;
    cp_async16(&st.k[r][c], kq + off, key < key_end);
    cp_async16(&st.v[r][c], vq + off, key < key_end);
  }
  // four scales a chunk: key0 is a multiple of kKeys and page of 4, so
  // the four keys of a chunk share a page and a 16-byte-aligned address
  for (int i = threadIdx.x; i < kKeys / 4; i += kThreads) {
    const int key = key0 + 4 * i;
    const bool valid = key < key_end;
    const size_t off = valid ? slot(key) : 0;
    cp_async16(&st.ks[4 * i], ks + off, valid);
    cp_async16(&st.vs[4 * i], vs + off, valid);
  }
}

// one layer's int8 store: values and per-(key, kv head) scales
struct Int8Pool {
  const int8_t* kq;
  const float* ks;
  const int8_t* vq;
  const float* vs;
};

inline Int8Pool int8_pool(const void* kq, const void* ks, const void* vq,
                          const void* vs) {
  return Int8Pool{static_cast<const int8_t*>(kq),
                  static_cast<const float*>(ks),
                  static_cast<const int8_t*>(vq),
                  static_cast<const float*>(vs)};
}

}  // namespace tpushare
