// int8 against bf16 selection products: a micro-benchmark of Hopper's
// tensor cores through wgmma fed by TMA, hand-written.
//
// Replaces the TPU kernel scripts/bench_int8_fusion_matmul.py::_kernel
// (pallas_call in run()), the micro-benchmark of the int8 serving mode's
// idea of running the fusion layers' one-hot selection products in int8.
// Every program computes what one TPU program computes, the same
// [HID, W] = [64, 400] float32 result:
//   acc = sum over (rep, rr, k) of s_i @ oh[k],
//   i = 1 + rep * TH * K + rr * K + k   (REPS = 4, TH = 8, K = 4: i = 1..128)
//   int8: s_i = int8(int32(slab) * i), wrapping modulo 256 as JAX's
//         .astype(int8) does; every product by wgmma ... .s32.s8.s8 into
//         one int32 accumulator that runs over all 128 products (exact:
//         |sum| <= 128 * 512 * 128 = 2^23), converted to float32 once;
//   bf16: s_i = bf16(slab * bf16(i)) (the product is exact in f32, rounded
//         once); every product by wgmma ... .f32.bf16.bf16 into one
//         float32 accumulator that runs over all 128 products.
// slab [64, 512], oh [4, 512, 400] (CAPR = 512), 0/1 entries. The wrapper
// (dcf_torch/ops/int8_mma.py) passes oh transposed, ohT [4, 400, 512]:
// K-major, as wgmma needs an 8-bit B operand. Every program writes the
// same values to the one output; `blocks` programs run on a persistent
// grid of min(blocks, SMs) CTAs, each walking over programs.
//
// Summation order (bf16): for k, for 128-byte-deep chunk c of oh[k], for
// the 32 products t that share oh[k], for the 4 wgmma depth steps of the
// chunk: acc += (16-term dot). Each element is one float32 sum of every
// nonzero term of its 128 products, in sequence; ops/int8_mma.py::
// selection_mma_tolerance bounds it for that n.
//
// What bounds it: operations. 2 * 64 * 512 * 400 * 128 = 3.36 GOP per
// program; at 989 TFLOP/s bf16 and 1,979 TOP/s int8 (H100 SXM, dense)
// 264 programs need 0.90 and 0.45 ms. Design for that:
//   - loop order k, then chunk, then the 32 products that share the
//     chunk: each [400 x 128 B] chunk of ohT[k] crosses L2 once per
//     program (800 KB int8, 1.6 MB bf16), not once per product;
//   - a producer warp keeps TMA loads of the chunks (two boxes of 200
//     rows, 128-byte swizzle) in flight into a ring of 4 stages of
//     51,200 bytes, signalled through mbarriers (full: the bytes arrived;
//     empty: the 8 consumer warps are done with the stage). The tensor
//     map is built on the host through cudaGetDriverEntryPoint, so the
//     link needs no -lcuda, and passed as a __grid_constant__ parameter.
//     A tensor map rather than 1-D cp.async.bulk copies: the TMA unit
//     applies the 128-byte swizzle that the wgmma descriptor reads, so
//     ohT stays as the wrapper makes it, with no pre-swizzled copy;
//   - two consumer warpgroups split N = 400: 200 + 200 columns for bf16
//     (m64n200k16), 208 + 192 for int8 (m64n208k32, m64n192k32: 200 is
//     not a legal s8 width); the B descriptor points into the stage with
//     128-byte swizzle, advancing 32 bytes per depth step;
//   - A comes from registers: each consumer thread loads its fragment of
//     the slab's chunk once, then scales it by i in registers for each of
//     the 32 products (two register sets in turn, so one product's
//     scaling overlaps the previous product's wgmma): no shared-memory
//     round trip and no block-wide barrier per product. The distinct
//     scale i per product keeps every product a product, as in the TPU
//     kernel;
//   - setmaxnreg moves registers from the producer warpgroup (40) to the
//     consumers (232), whose accumulators (100 or 104 per thread) stay
//     in registers for the whole program.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHid = 64, kCapr = 512, kW = 400, kK = 4, kTH = 8, kReps = 4;
constexpr int kProducts = kReps * kTH;      // products per oh[k]: 32
constexpr int kStages = 4;
constexpr int kChunkBytes = 128;            // depth per stage (one swizzle atom)
constexpr int kBoxRows = 200;               // TMA box: 200 rows of ohT[k]
constexpr int kStageBytes = kW * kChunkBytes;   // 51,200
constexpr int kSteps = kChunkBytes / 32;    // wgmma depth steps per chunk
constexpr int kThreads = 384;               // 2 consumer + 1 producer WG
constexpr size_t kSmemBytes = (size_t)kStages * kStageBytes + 1024;

// D[64, 200] (+)= A[64, 32 B] (registers) x B (smem descriptor)
__device__ __forceinline__ void wgmma_bf16_n200(float (&d)[100],
    const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %105, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n200k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99}, "
      "{%100, %101, %102, %103}, %104, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// D[64, 208] (+)= A[64, 32 B] (registers) x B (smem descriptor)
__device__ __forceinline__ void wgmma_s8_n208(int (&d)[104],
    const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %109, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103}, "
      "{%104, %105, %106, %107}, %108, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// D[64, 192] (+)= A[64, 32 B] (registers) x B (smem descriptor)
__device__ __forceinline__ void wgmma_s8_n192(int (&d)[96],
    const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// One box of the tensor map (coordinates innermost first) into shared
// memory, completion counted on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x),
      "r"(y)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the tile
// 1024-byte aligned (base offset 0); LBO is unused for this layout.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// s_i for one 32-bit word of the slab (4 int8 or 2 bf16 values)
template <bool kInt8>
__device__ __forceinline__ uint32_t scale_word(uint32_t v, uint32_t i) {
  if constexpr (kInt8) {
    // bytewise (x * i) mod 256 in two 16-bit lanes per multiply: a byte
    // times i <= 128 stays below 2^16, so no lane carries into the next
    const uint32_t even = ((v & 0x00ff00ffu) * i) & 0x00ff00ffu;
    const uint32_t odd = (((v >> 8) & 0x00ff00ffu) * i) & 0x00ff00ffu;
    return even | (odd << 8);
  } else {
    const float fi = (float)i;
    const float lo = __uint_as_float(v << 16) * fi;
    const float hi = __uint_as_float(v & 0xffff0000u) * fi;
    __nv_bfloat162 o = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&o);
  }
}

template <bool kInt8, int N>
struct Mma;
template <>
struct Mma<false, 200> {
  using Acc = float;
  static constexpr int kRegs = 100;
  static __device__ __forceinline__ void run(float (&d)[100],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int acc) {
    wgmma_bf16_n200(d, a, desc, acc);
  }
};
template <>
struct Mma<true, 208> {
  using Acc = int;
  static constexpr int kRegs = 104;
  static __device__ __forceinline__ void run(int (&d)[104],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int acc) {
    wgmma_s8_n208(d, a, desc, acc);
  }
};
template <>
struct Mma<true, 192> {
  using Acc = int;
  static constexpr int kRegs = 96;
  static __device__ __forceinline__ void run(int (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int acc) {
    wgmma_s8_n192(d, a, desc, acc);
  }
};

// One product of the chunk: A = s_i (registers), B = the stage's columns
// of this warpgroup, kSteps depth steps of 32 bytes.
template <bool kInt8, int N>
__device__ __forceinline__ void product(
    typename Mma<kInt8, N>::Acc (&acc)[Mma<kInt8, N>::kRegs],
    const uint32_t (&raw)[kSteps][4], uint32_t (&a)[kSteps][4], uint32_t i,
    uint64_t desc, bool first) {
#pragma unroll
  for (int j = 0; j < kSteps; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) a[j][q] = scale_word<kInt8>(raw[j][q], i);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kSteps; ++j)   // + 32 bytes per depth step
    Mma<kInt8, N>::run(acc, a[j], desc + 2 * j, first && j == 0 ? 0 : 1);
  wgmma_commit();
}

// A consumer warpgroup: columns [col0, col0 + N) of every program.
template <bool kInt8, int N>
__device__ __forceinline__ void consume(const uint32_t* __restrict__ slab,
                                        float* __restrict__ out,
                                        const char* stages, uint64_t* full,
                                        uint64_t* empty, int col0,
                                        int programs) {
  using M = Mma<kInt8, N>;
  static_assert(kHid == 4 * 16, "a warpgroup's 4 warps own 16 rows each");
  constexpr int kRowWords = kCapr * (kInt8 ? 1 : 2) / 4;
  constexpr int kChunks = kCapr * (kInt8 ? 1 : 2) / kChunkBytes;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = 16 * warp + g;
  const uint32_t* a0p = slab + row0 * kRowWords + tig;
  const uint32_t* a1p = a0p + 8 * kRowWords;

  typename M::Acc acc[M::kRegs];
  uint32_t raw[kSteps][4], sa[kSteps][4], sb[kSteps][4];
  int stage = 0;
  uint32_t phase = 0;
  for (int prog = blockIdx.x; prog < programs; prog += gridDim.x) {
    for (int k = 0; k < kK; ++k) {
      for (int c = 0; c < kChunks; ++c) {
        // this thread's A fragments of the chunk: rows g and g + 8 of
        // its warp's 16, 4-byte words at tig and tig + 4 of each 32-byte
        // depth step
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          const int o = c * (kChunkBytes / 4) + j * 8;
          raw[j][0] = __ldg(a0p + o);
          raw[j][1] = __ldg(a1p + o);
          raw[j][2] = __ldg(a0p + o + 4);
          raw[j][3] = __ldg(a1p + o + 4);
        }
        mbar_wait(&full[stage], phase);
        const uint64_t desc =
            desc_sw128(stages + stage * kStageBytes + col0 * kChunkBytes);
        const bool first = k == 0 && c == 0;
#pragma unroll 1
        for (int rr = 0; rr < kProducts; rr += 2) {
          // product rr + 1 uses sb while rr's wgmma may still read sa,
          // and the other way round: wait_group 1 retires the older one
          product<kInt8, N>(acc, raw, sa, 1 + rr * kK + k, desc,
                            first && rr == 0);
          wgmma_wait<1>();
          product<kInt8, N>(acc, raw, sb, 1 + (rr + 1) * kK + k, desc,
                            false);
          wgmma_wait<1>();
        }
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    // accumulator fragment: per 8 columns jn, (row0, 2 tig .. + 1) and
    // (row0 + 8, 2 tig .. + 1)
#pragma unroll
    for (int jn = 0; jn < N / 8; ++jn) {
      const int col = col0 + 8 * jn + 2 * tig;
      *reinterpret_cast<float2*>(out + row0 * kW + col) =
          make_float2((float)acc[4 * jn], (float)acc[4 * jn + 1]);
      *reinterpret_cast<float2*>(out + (row0 + 8) * kW + col) =
          make_float2((float)acc[4 * jn + 2], (float)acc[4 * jn + 3]);
    }
  }
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads, 1)
selection_mma_kernel(const __grid_constant__ CUtensorMap oht_map,
                     const uint32_t* __restrict__ slab,
                     float* __restrict__ out, int programs) {
  constexpr int kN0 = kInt8 ? 208 : 200;
  constexpr int kN1 = kW - kN0;
  constexpr int kChunks = kCapr * (kInt8 ? 1 : 2) / kChunkBytes;
  constexpr int kBoxCols = kChunkBytes / (kInt8 ? 1 : 2);   // elements
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  extern __shared__ char smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: align the ring to that
  char* stages = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);

  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int prog = blockIdx.x; prog < programs; prog += gridDim.x) {
        for (int k = 0; k < kK; ++k) {
          for (int c = 0; c < kChunks; ++c) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], kStageBytes);
            char* dst = stages + stage * kStageBytes;
            tma_load(dst, &oht_map, c * kBoxCols, k * kW, &full[stage]);
            tma_load(dst + kBoxRows * kChunkBytes, &oht_map, c * kBoxCols,
                     k * kW + kBoxRows, &full[stage]);
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else if (wg == 0) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume<kInt8, kN0>(slab, out, stages, full, empty, 0, programs);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume<kInt8, kN1>(slab, out, stages, full, empty, kN0, programs);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <bool kInt8>
cudaError_t launch(const void* slab, const void* oht, void* out, int blocks,
                   cudaStream_t stream) {
  if (blocks <= 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(oht) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(slab) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // ohT [K * W, CAPR] viewed in 2-D, boxes of 200 rows x 128 bytes
  const int elem = kInt8 ? 1 : 2;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)kCapr, (cuuint64_t)kK * kW};
  const cuuint64_t strides[1] = {(cuuint64_t)kCapr * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(kChunkBytes / elem),
                             (cuuint32_t)kBoxRows};
  const cuuint32_t estr[2] = {1, 1};
  if (encode(&map,
             kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             2, const_cast<void*>(oht), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  // once, outside any capture: the ring needs more than 48 KB, and the
  // grid is one CTA per SM at most
  static bool ready = false;
  static int sms = 0;
  if (!ready) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(selection_mma_kernel<kInt8>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kSmemBytes);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const int grid = blocks < sms ? blocks : sms;
  selection_mma_kernel<kInt8><<<grid, kThreads, kSmemBytes, stream>>>(
      map, static_cast<const uint32_t*>(slab), static_cast<float*>(out),
      blocks);
  return cudaGetLastError();
}

}  // namespace

// slab [64, 512] int8, oht [4, 400, 512] int8, out [64, 400] f32;
// `blocks` programs
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
