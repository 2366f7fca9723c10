// int8 against bf16 selection products: a micro-benchmark of Hopper's
// tensor cores through mma.sync, hand-written.
//
// Replaces the TPU kernel scripts/bench_int8_fusion_matmul.py::_kernel
// (pallas_call in run()), the micro-benchmark of the int8 serving mode's
// idea of running the fusion layers' one-hot selection products in int8.
// Every block computes what one TPU program computes, the same
// [HID, W] = [64, 400] float32 result:
//   acc = sum over (rep, rr, k) of s_i @ oh[k],
//   i = 1 + rep * TH * K + rr * K + k   (REPS = 4, TH = 8, K = 4: i = 1..128)
//   int8: s_i = int8(int32(slab) * i), wrapping modulo 256 as JAX's
//         .astype(int8) does; s_i @ oh[k] by
//         mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, exact in int32,
//         then added into the float32 sum;
//   bf16: s_i = bf16(slab * bf16(i)) (the product is exact in f32, rounded
//         once); s_i @ oh[k] by mma.sync.aligned.m16n8k16.row.col.f32.bf16.
//         bf16.f32 into a fresh f32 tile, then added into the sum.
// slab [64, 512], oh [4, 512, 400] (CAPR = 512), 0/1 entries. The wrapper
// (dcf_torch/ops/int8_mma.py) passes oh transposed, ohT [4, 400, 512],
// so that each thread's B fragment is two aligned 32-bit loads. Every
// block writes the same values to the one output.
//
// Loop order: k outer, then (rep, rr): oh[k] stays hot in L1 / L2 over
// the 32 products that use it, as the TPU kernel keeps oh resident in
// VMEM. The int8 sum is exact in any order (integers below 2^24); the
// bf16 sum rounds in f32 in this order, not the TPU's.
//
// What bounds it: operations. 2 * 64 * 512 * 400 * 128 = 3.36 GOP per
// block; at 989 TFLOP/s bf16 and 1,979 TOP/s int8 (H100 SXM, dense, the
// wgmma peak) 264 blocks need 0.90 and 0.45 ms. mma.sync is not wgmma:
// this simple kernel is not built to reach that peak. Design: 8 warps,
// warp w owns rows 16 (w % 4) .. +16 and every other 8-column tile from
// w / 4, 25 tiles, their float32 sums in registers. Per product the
// block writes s_i into shared memory (rows padded by 16 bytes, so the A
// fragments' 32-bit loads hit 32 distinct banks), then each warp runs
// its 25 tiles, A from shared memory, B from ohT through the read-only
// cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHid = 64, kCapr = 512, kW = 400, kK = 4, kTH = 8, kReps = 4;
constexpr int kThreads = 256;               // 8 warps
constexpr int kTilesPerWarp = kW / 8 / 2;   // 25 tiles of 16 x 8
constexpr int kStepWords = 8;               // 32 bytes of depth per mma

template <bool kInt8>
struct Shape {
  static constexpr int kElem = kInt8 ? 1 : 2;                 // bytes
  static constexpr int kRowWords = kCapr * kElem / 4;         // global row
  static constexpr int kSmemRowWords = kRowWords + 4;         // + 16 B pad
  static constexpr int kSteps = kCapr * kElem / 32;           // mma per row
  static constexpr size_t kSmemBytes = sizeof(uint32_t) * kHid *
                                       kSmemRowWords;
};

// s_i for one 32-bit word of the slab
__device__ __forceinline__ uint32_t scale_word(uint32_t v, int i,
                                               bool int8) {
  if (int8) {
    uint32_t r = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int x = (int)(int8_t)((v >> (8 * b)) & 0xffu);
      r |= ((uint32_t)(x * i) & 0xffu) << (8 * b);   // wraps modulo 256
    }
    return r;
  }
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  const float2 f = __bfloat1622float2(h);
  const float fi = (float)i;
  __nv_bfloat162 o = __floats2bfloat162_rn(f.x * fi, f.y * fi);
  return *reinterpret_cast<uint32_t*>(&o);
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads, 1)
selection_mma_kernel(const uint32_t* __restrict__ slab,
                     const uint32_t* __restrict__ oht,
                     float* __restrict__ out) {
  using S = Shape<kInt8>;
  extern __shared__ uint32_t s_a[];          // s_i, [kHid][kSmemRowWords]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int mt = warp & 3, nb = warp >> 2;
  const uint32_t* a0p = s_a + (mt * 16 + g) * S::kSmemRowWords + tig;
  const uint32_t* a1p = a0p + 8 * S::kSmemRowWords;

  float acc[kTilesPerWarp][4];
#pragma unroll
  for (int j = 0; j < kTilesPerWarp; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;

  for (int k = 0; k < kK; ++k) {
    const uint32_t* ohk = oht + (size_t)k * kW * S::kRowWords;
    for (int t = 0; t < kReps * kTH; ++t) {
      const int i = 1 + t * kK + k;
      __syncthreads();                       // the last s_i is read
      for (int e = threadIdx.x; e < kHid * S::kRowWords; e += kThreads) {
        const int row = e / S::kRowWords, col = e - row * S::kRowWords;
        s_a[row * S::kSmemRowWords + col] =
            scale_word(__ldg(slab + e), i, kInt8);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kTilesPerWarp; ++j) {
        const uint32_t* bp = ohk + ((nb + 2 * j) * 8 + g) * S::kRowWords +
                             tig;
        if constexpr (kInt8) {
          int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
#pragma unroll 4
          for (int ks = 0; ks < S::kSteps; ++ks) {
            const int o = ks * kStepWords;
            asm volatile(
                "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
                "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                : "+r"(c0), "+r"(c1), "+r"(c2), "+r"(c3)
                : "r"(a0p[o]), "r"(a1p[o]), "r"(a0p[o + 4]),
                  "r"(a1p[o + 4]), "r"(__ldg(bp + o)), "r"(__ldg(bp + o + 4)));
          }
          acc[j][0] += (float)c0;
          acc[j][1] += (float)c1;
          acc[j][2] += (float)c2;
          acc[j][3] += (float)c3;
        } else {
          float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
#pragma unroll 4
          for (int ks = 0; ks < S::kSteps; ++ks) {
            const int o = ks * kStepWords;
            asm volatile(
                "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
                : "r"(a0p[o]), "r"(a1p[o]), "r"(a0p[o + 4]),
                  "r"(a1p[o + 4]), "r"(__ldg(bp + o)), "r"(__ldg(bp + o + 4)));
          }
          acc[j][0] += c0;
          acc[j][1] += c1;
          acc[j][2] += c2;
          acc[j][3] += c3;
        }
      }
    }
  }

  // C fragment: (row g, cols 2 tig, 2 tig + 1) and the same 8 rows below
  const int row = mt * 16 + g;
#pragma unroll
  for (int j = 0; j < kTilesPerWarp; ++j) {
    const int col = (nb + 2 * j) * 8 + 2 * tig;
    out[row * kW + col] = acc[j][0];
    out[row * kW + col + 1] = acc[j][1];
    out[(row + 8) * kW + col] = acc[j][2];
    out[(row + 8) * kW + col + 1] = acc[j][3];
  }
}

template <bool kInt8>
cudaError_t launch(const void* slab, const void* oht, void* out, int blocks,
                   cudaStream_t stream) {
  using S = Shape<kInt8>;
  if (blocks <= 0) return cudaErrorInvalidValue;
  // above 48 KB (bf16) only after opting in; once, outside any capture
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        selection_mma_kernel<kInt8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmemBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  selection_mma_kernel<kInt8><<<blocks, kThreads, S::kSmemBytes, stream>>>(
      static_cast<const uint32_t*>(slab), static_cast<const uint32_t*>(oht),
      static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// slab [64, 512] int8, oht [4, 400, 512] int8, out [64, 400] f32
extern "C" int dcf_selection_mma_int8(const void* slab, const void* oht,
                                      void* out, int blocks, void* stream) {
  return launch<true>(slab, oht, out, blocks,
                      static_cast<cudaStream_t>(stream));
}

// slab [64, 512] bf16, oht [4, 400, 512] bf16, out [64, 400] f32
extern "C" int dcf_selection_mma_bf16(const void* slab, const void* oht,
                                      void* out, int blocks, void* stream) {
  return launch<false>(slab, oht, out, blocks,
                       static_cast<cudaStream_t>(stream));
}
