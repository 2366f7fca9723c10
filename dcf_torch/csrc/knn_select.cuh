// The K-nearest selection shared by the fusion forward (fusion_fwd.cu)
// and the standalone KNN selection (knn.cu): 64-bit candidate keys,
// sorted K-lists kept in registers, the bitonic merge of two lanes'
// lists, and the 16-byte cp.async that stages a payload.
//
// A candidate's key is d2 (non-negative, below 1e30, so its bits order
// as an unsigned integer does) above its index. Both kernels use the
// candidate's slot in the tile's halo as the index: it orders one
// pixel's candidates as the plain version's scan does (window shift,
// then bin slot), so the K smallest keys are the plain version's
// repeated first-minimum argmin, ties included.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dcf {

typedef unsigned long long Key;
constexpr Key kEmpty = ~0ull;   // an empty list entry, above every key

__device__ __forceinline__ Key make_key(float d, int s) {
  return ((Key)__float_as_uint(d) << 32) | (unsigned)s;
}
__device__ __forceinline__ float key_d(Key k) {
  return __uint_as_float((unsigned)(k >> 32));
}
__device__ __forceinline__ int key_s(Key k) { return (int)(unsigned)k; }

// Insert a key into the sorted K-list of the K smallest. All K
// comparisons are made against the old list at once, so the chain is a
// few operations deep, not K: entry k takes the new key if it is the
// first greater one, entry k - 1's if a greater one came before.
template <int K>
__device__ __forceinline__ void insert(Key (&bk)[K], Key key) {
  bool lt[K];
#pragma unroll
  for (int k = 0; k < K; ++k) lt[k] = key < bk[k];
#pragma unroll
  for (int k = K - 1; k > 0; --k)
    if (lt[k]) bk[k] = lt[k - 1] ? bk[k - 1] : key;
  if (lt[0]) bk[0] = key;
}

// The K smallest keys of two sorted K-lists, sorted, into bk: c[k] =
// min(a[k], b[K-1-k]) holds the K smallest of the union (a bitonic
// sequence), which an odd-even transposition network of K rounds then
// sorts. Both partners of a butterfly get the same list.
template <int K>
__device__ __forceinline__ void merge(Key (&bk)[K], const Key (&ok)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) bk[k] = min(bk[k], ok[K - 1 - k]);
#pragma unroll
  for (int round = 0; round < K; ++round) {
#pragma unroll
    for (int k = round & 1; k + 1 < K; k += 2) {
      const Key lo = min(bk[k], bk[k + 1]), hi = max(bk[k], bk[k + 1]);
      bk[k] = lo;
      bk[k + 1] = hi;
    }
  }
}

// The butterfly: the L lanes of a pixel (L consecutive lanes of one
// warp, L a power of two dividing 32) merge their lists until every
// lane holds the pixel's K smallest. All 32 lanes must call it.
template <int K>
__device__ __forceinline__ void merge_lanes(Key (&bk)[K], int L) {
  for (int off = 1; off < L; off <<= 1) {
    Key ok[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      ok[k] = __shfl_xor_sync(0xffffffffu, bk[k], off);
    merge<K>(bk, ok);
  }
}

// Bit c set where slot c of the cell at valid[base] is valid (C <= 32):
// 8-byte loads where `wide` (C % 8 == 0 and valid 8-byte aligned), else
// one byte per slot.
__device__ __forceinline__ uint32_t slot_mask(const uint8_t* valid,
                                              size_t base, int C,
                                              bool wide) {
  uint32_t m = 0;
  if (wide) {
    const uint2* v8 = reinterpret_cast<const uint2*>(valid + base);
    for (int q = 0; q < C / 8; ++q) {
      const uint2 v = __ldg(v8 + q);
      // one bit per nonzero byte, low byte first
      const uint32_t lo = __vcmpne4(v.x, 0u) & 0x01010101u;
      const uint32_t hi = __vcmpne4(v.y, 0u) & 0x01010101u;
      const uint32_t m8 = ((lo | lo >> 7 | lo >> 14 | lo >> 21) & 0xfu) |
                          ((hi | hi >> 7 | hi >> 14 | hi >> 21) & 0xfu) << 4;
      m |= m8 << (8 * q);
    }
  } else {
    for (int c = 0; c < C; ++c) m |= (valid[base + c] ? 1u : 0u) << c;
  }
  return m;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

}  // namespace dcf
