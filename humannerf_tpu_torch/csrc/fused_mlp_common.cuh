// Device code shared by the fused-MLP forward kernel (fused_mlp.cu) and its
// backward kernel (fused_mlp_bwd.cu): the net descriptor, the Hopper layer
// primitive of the bfloat16 kernels, and the register-tiled float32 layer
// primitive (its own section below: fmaf on 64-sample blocks, weights
// staged in shared memory by cp.async). The bfloat16 primitive:
//
//   * a block works on one 128-sample liveness tile at a time and walks
//     over the tiles (a persistent grid, one block an SM; the tiles are
//     handed out by an atomic counter);
//   * two consumer warpgroups, 64 rows each, run wgmma.mma_async m64nNk16
//     with A (activations) and B (weights) in shared memory and the sums in
//     registers as f32;
//   * the weights' k-chunks (64 input rows x the layer's width, pre-tiled
//     and pre-swizzled by the wrapper) stream through a ring of stages with
//     cp.async.bulk, each stage guarded by a pair of mbarriers: in the
//     forward a producer warp keeps them in flight, in the backward the
//     consumers refill the ring themselves (fused_mlp_bwd.cu says why);
//   * activations stay in shared memory in wgmma's 128-byte-swizzled
//     K-major layout, and each layer's epilogue writes its output from the
//     accumulator registers straight into that layout, in place.
//
// Registers: ptxas allocates the whole kernel, consumers included, within
// the kernel's own register count, which is 65536 / (threads rounded up to
// whole warpgroups): 168 for a block of two consumer warpgroups and a
// producer warp (measured: neither setmaxnreg nor 288 instead of 384 threads
// changes the allocation). The forward's consumers fit in 168 without a
// spill; the backward's do not, and run as a 256-thread block (255).
//
// Everything has internal linkage; each .cu includes it once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TILE = 128;       // liveness granularity, in samples
constexpr int TM = 64;          // samples a float32 block: half a tile
constexpr int MAX_DEPTH = 12;
constexpr int MAX_WIDTH = 256;
constexpr int MAX_EPAD = 64;
constexpr int MAX_FREQ = 16;

struct NetDesc {
  int depth;      // hidden layers
  int width;      // hidden width: multiple of 64, <= MAX_WIDTH
  int multires;   // embedding frequencies
  int epad;       // embedding width padded to a multiple of 16, <= MAX_EPAD
  int n_out;      // 3 (offset) or 4 (rgb, sigma)
  // hidden-layer weights: f32 as (in, out); bf16 packed into k-chunks of
  // 64 input rows, each (width, 64) with the 128-byte swizzle (see
  // `pack_kernel_weights` in ops/fused_mlp.py)
  const void* w_h[MAX_DEPTH];   // the (width) inputs that meet h, or null
  const void* w_e[MAX_DEPTH];   // the (epad) inputs that meet the embed, or null
  const float* b[MAX_DEPTH];    // (width,)
  const void* w_out;            // (width, n_out)
  const float* b_out;           // (n_out,)
};

struct Params {
  const float* x;       // (n, 3)
  float* out;           // (n, 4)
  long long n;
  const int* live;      // (ceil(n / TILE),)
  int* next_tile;       // bf16: tile counter of the persistent grid, zeroed
  float hann[MAX_FREQ]; // hann window weight per non-rigid frequency
  int skip_nr;          // 1: xyz = x, no non-rigid net
  NetDesc nr;
  NetDesc cnl;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);   // round to nearest even
}

// ===========================================================================
// The Hopper layer primitive (bfloat16)
// ===========================================================================

constexpr int PANEL_BYTES = TILE * 128;   // 64 bf16 columns of a tile
constexpr int ACT_BYTES = PANEL_BYTES * (MAX_WIDTH / 64);
constexpr int EMB_BYTES = PANEL_BYTES;    // epad <= 64
constexpr int CHUNK_MAX_BYTES = MAX_WIDTH * 128;   // (width, 64) bf16
constexpr int CONSUMERS = 256;            // two warpgroups
constexpr int THREADS_H = CONSUMERS + 32;    // and a producer warp
constexpr int DE_LD = MAX_EPAD + 8;       // row stride of the f32 dE rows
// A barrier wait longer than this is a broken pipeline: trap instead of
// hanging the card (the launch then fails with an error the wrapper sees).
constexpr unsigned long long WAIT_LIMIT_NS = 2000000000ull;

// Byte offset of bf16 element (r, c) in a tile-wide buffer of panels: panel
// c / 64 holds 64 columns, row r of it is 128 bytes whose 16-byte groups are
// XOR-swizzled by r % 8 (the 128-byte swizzle that wgmma's descriptors
// name; every buffer starts 1024-byte aligned).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((c >> 6) * PANEL_BYTES + r * 128
                    + ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// ---- mbarriers and bulk copies
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}
// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try(bar, parity))
    if (global_ns() - t0 > WAIT_LIMIT_NS) __trap();
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// the stores issued by this thread have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// the stores issued by this thread are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// generic-proxy writes to shared memory become visible to wgmma and bulk copies
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void wg_sync(int wg) { named_sync(1 + wg, 128); }
__device__ __forceinline__ void consumers_sync() {
  named_sync(3, CONSUMERS);
}

// ---- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from touching accumulators while a wgmma owns them
template <int M> __device__ __forceinline__ void fence_regs(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int M> __device__ __forceinline__ void zero(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) d[i] = 0.0f;
}

// Shared-memory matrix descriptor with the 128-byte swizzle. K-major: rows
// 128 bytes apart, 8-row groups `sbo` apart (`lbo` unused). MN-major: 64
// contiguous elements a row, K rows 128 bytes apart, 8-row groups `sbo`
// apart, 64-element blocks `lbo` apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
       | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
       | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t kmajor(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr) {
  return desc_sw128(addr, PANEL_BYTES, 1024);
}

// D (64 x N, f32, registers) += A (64 x 16) B (16 x N), both from shared
// memory; TA / TB: 1 where the operand is MN-major. Accumulator layout
// (PTX m64nNk16): warp w of the warpgroup holds rows 16w..16w+15; lane l
// holds d[4j], d[4j+1] at row 16w + l/4, columns 8j + 2(l%4) + {0, 1}, and
// d[4j+2], d[4j+3] eight rows below.
template <int N, int TA, int TB> struct Wgmma;

template <int TA, int TB> struct Wgmma<64, TA, TB> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB> struct Wgmma<128, TA, TB> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB> struct Wgmma<192, TA, TB> {
  __device__ __forceinline__ static void mma(float (&d)[96], uint64_t a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
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
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB> struct Wgmma<256, TA, TB> {
  __device__ __forceinline__ static void mma(float (&d)[128], uint64_t a,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
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
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
};

// ---- the pipelines between the producer warp and the consumers

// Inputs of one tile, written by the producer warp.
struct TileSlot {
  int tile;               // -1: no tiles left
  int rows;               // valid rows (the last tile may be ragged)
  int pad[2];
  float x[TILE * 3];
  float g[TILE * 4];      // backward only: the cotangent of raw
};

// The weight ring as the producer sees it: one chunk a stage, loaded by one
// thread with cp.async.bulk, its arrival counted in bytes by `full`.
struct Feed {
  uint32_t full, empty, data;   // shared addresses: barriers, stage 0
  int nstage, stage;
  uint32_t phase;
  __device__ void load(const void* src, uint32_t bytes) {
    mbar_wait(empty + 8 * stage, phase ^ 1);
    mbar_expect_tx(full + 8 * stage, bytes);
    bulk_load(data + stage * CHUNK_MAX_BYTES, src, bytes, full + 8 * stage);
    if (++stage == nstage) { stage = 0; phase ^= 1; }
  }
};

// The weight ring as a consumer warpgroup sees it. A stage goes back to the
// producer when every consumer warp has waited for the products reading it
// (`empty` counts one arrival a warp).
struct Ring {
  uint32_t full, empty, data;
  int nstage, stage;
  uint32_t phase;
  __device__ uint32_t wait() {
    mbar_wait(full + 8 * stage, phase);
    return data + stage * CHUNK_MAX_BYTES;
  }
  __device__ void release(int s) const {
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * s);
  }
  __device__ void next() {
    if (++stage == nstage) { stage = 0; phase ^= 1; }
  }
};

// Two tile slots as the consumers see them (`empty` counts every consumer
// thread).
struct TileFeed {
  TileSlot* slot;
  uint32_t full, empty;
  int k;
  uint32_t phase;
  __device__ const TileSlot* next() {
    mbar_wait(full + 8 * k, phase);
    return slot[k].tile < 0 ? nullptr : &slot[k];
  }
  __device__ void release() {
    mbar_arrive(empty + 8 * k);
    if (++k == 2) { k = 0; phase ^= 1; }
  }
};

// The producer warp: takes tiles from the counter until none is left. A
// dead tile only gets its zeros (`dead(tile, rows)`, all lanes); a live one
// has its inputs copied into a slot (`fill(slot, tile, rows)`, all lanes)
// and its weight chunks streamed in the consumers' order (`stream()`, lane
// 0). Ends by handing the consumers an empty slot.
template <class Dead, class Fill, class Stream>
__device__ void produce(long long n, const int* live, int* next_tile,
                        TileSlot* slot, uint32_t full, uint32_t empty,
                        Dead dead, Fill fill, Stream stream) {
  const int lane = threadIdx.x & 31;
  const long long n_tiles = (n + TILE - 1) / TILE;
  int k = 0;
  uint32_t phase = 0;
  for (;;) {
    int t = 0;
    if (lane == 0) t = atomicAdd(next_tile, 1);
    t = __shfl_sync(0xffffffffu, t, 0);
    const bool done = t >= n_tiles;
    int rows = 0;
    if (!done) {
      const long long r = n - (long long)t * TILE;
      rows = r < TILE ? (int)r : TILE;
      if (live[t] == 0) {
        dead(t, rows);
        continue;
      }
    }
    mbar_wait(empty + 8 * k, phase ^ 1);
    TileSlot& s = slot[k];
    if (lane == 0) {
      s.tile = done ? -1 : t;
      s.rows = rows;
    }
    if (!done) fill(s, t, rows);
    mbar_arrive(full + 8 * k);        // 32 arrivals: every lane's writes
    if (done) return;
    if (lane == 0) stream();
    __syncwarp();
    if (++k == 2) { k = 0; phase ^= 1; }
  }
}

// One net's weight chunks in the order its forward consumes them, handed to
// `f.load(src, bytes)`.
template <class Sink>
__device__ void stream_forward(const NetDesc& net, Sink& f) {
  const uint32_t cb = net.width * 128;
  for (int li = 0; li < net.depth; ++li) {
    if (net.w_h[li] != nullptr)
      for (int c = 0; c < net.width / 64; ++c)
        f.load(static_cast<const unsigned char*>(net.w_h[li]) + c * cb, cb);
    if (net.w_e[li] != nullptr) f.load(net.w_e[li], cb);
  }
}

// ---- the consumers' building blocks (one warpgroup, its 64 rows)

// The shared buffers a consumer warpgroup works on: shared addresses for
// wgmma and bulk copies, generic pointers for its own loads and stores.
struct Bufs {
  uint32_t act, emb;
  unsigned char* act_p;
  unsigned char* emb_p;
};

// One hidden layer: acc = [h | emb] @ [w_h ; w_e] from the ring's chunks
// (w_h's width / 64 chunks, then w_e's one), then bias, relu in f32 and
// rounding to bf16, written over h in place (a warpgroup reads and writes
// only its own rows, and only after its products are done). p_in: panels of
// h that meet w_h (0 for a first layer); e_steps: epad / 16 where the layer
// meets the embedding, else 0. store: where the backward keeps this layer's
// output (the block's scratch), or null. R: the ring (Ring, or the
// backward's FedRing).
template <int N, class R>
__device__ __forceinline__ void layer_fwd(R& rg, const Bufs& b, int p_in,
                                          int e_steps,
                                          const float* __restrict__ bias,
                                          unsigned char* store, int wg) {
  const int tid = threadIdx.x & 127;
  const uint32_t rows = wg * 64 * 128;
  float acc[N / 2];
  zero(acc);
  int prev = -1;
  auto chunk = [&](uint32_t a, int ksteps) {
    const uint32_t w = rg.wait();
    wgmma_fence();
    for (int kk = 0; kk < ksteps; ++kk)
      Wgmma<N, 0, 0>::mma(acc, kmajor(a + rows + kk * 32),
                          kmajor(w + kk * 32));
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      rg.release(prev);
    }
    prev = rg.stage;
    rg.next();
  };
  for (int c = 0; c < p_in; ++c) chunk(b.act + c * PANEL_BYTES, 4);
  if (e_steps > 0) chunk(b.emb, e_steps);
  wgmma_wait<0>();
  fence_regs(acc);
  rg.release(prev);
  if (store != nullptr) {       // the last layer's store has read h
    if (tid == 0) bulk_wait_read();
    wg_sync(wg);
  }

  const int lane = tid & 31;
  const int r = wg * 64 + (tid >> 5) * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 bj = __ldg(reinterpret_cast<const float2*>(bias + 8 * j + cq));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint32_t off = (j >> 3) * PANEL_BYTES + (r + 8 * hh) * 128
                         + (((j & 7) ^ (lane >> 2)) << 4) + (lane & 3) * 4;
      *reinterpret_cast<__nv_bfloat162*>(b.act_p + off) =
          __floats2bfloat162_rn(fmaxf(acc[4 * j + 2 * hh] + bj.x, 0.0f),
                                fmaxf(acc[4 * j + 2 * hh + 1] + bj.y, 0.0f));
    }
  }
  fence_async_smem();
  wg_sync(wg);
  if (store != nullptr && tid == 0) {
    for (int pnl = 0; pnl < N / 64; ++pnl)
      bulk_store(store + pnl * PANEL_BYTES + wg * 8192,
                 b.act + pnl * PANEL_BYTES + wg * 8192, 8192);
    bulk_commit();
  }
}

// One net's hidden layers; the last h is left in the activation buffer.
// store: the block's scratch for this net ((depth, TILE, width) in the
// shared buffer's layout), or null.
template <class R>
__device__ void run_net(const NetDesc& net, R& rg, const Bufs& b,
                        unsigned char* store, int wg) {
  const size_t layer_bytes = (size_t)TILE * net.width * 2;
  for (int li = 0; li < net.depth; ++li) {
    const int p_in = net.w_h[li] != nullptr ? net.width / 64 : 0;
    const int e_steps = net.w_e[li] != nullptr ? net.epad / 16 : 0;
    unsigned char* st = store != nullptr ? store + li * layer_bytes : nullptr;
    switch (net.width) {
      case 64: layer_fwd<64>(rg, b, p_in, e_steps, net.b[li], st, wg); break;
      case 128: layer_fwd<128>(rg, b, p_in, e_steps, net.b[li], st, wg); break;
      case 192: layer_fwd<192>(rg, b, p_in, e_steps, net.b[li], st, wg); break;
      default: layer_fwd<256>(rg, b, p_in, e_steps, net.b[li], st, wg); break;
    }
  }
}

// Fourier embedding of this warpgroup's 64 rows of pts (TILE, 3) into the
// swizzled embedding panel, all 64 columns (past the used ones: 0). lead3:
// the canonical embed starts with the point itself; hann: per-frequency
// window weight (non-rigid embed) or null.
__device__ void embed_rows(const float* pts, int multires, bool lead3,
                           const float* hann, unsigned char* emb_p, int wg) {
  const int lead = lead3 ? 3 : 0;
  for (int idx = threadIdx.x & 127; idx < 64 * 32; idx += 128) {
    const int r = wg * 64 + (idx >> 5);
    const int c0 = (idx & 31) * 2;
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + e;
      v[e] = 0.0f;
      if (c < lead) {
        v[e] = pts[r * 3 + c];
      } else if (c < lead + 6 * multires) {
        const int j = c - lead;
        const int f = j / 6;
        const int q = j - 6 * f;
        const int d = q >= 3 ? q - 3 : q;
        const float s = pts[r * 3 + d] * (float)(1 << f);
        v[e] = q >= 3 ? cosf(s) : sinf(s);
        if (hann != nullptr) v[e] *= hann[f];
      }
    }
    *reinterpret_cast<__nv_bfloat162*>(emb_p + swz(r, c0)) =
        __floats2bfloat162_rn(v[0], v[1]);
  }
}

// The narrow output layer (n_out = 3 or 4 columns) of this warpgroup's rows
// on CUDA cores: two threads a row, each over half of h's columns, f32
// sums. Both threads of the pair return the row's outputs (bias not added).
__device__ __forceinline__ void out_rows(const unsigned char* act_p, int width, int n_out,
                         const bf16* __restrict__ w_out, int wg,
                         float (&res)[4], int& row) {
  const int tid = threadIdx.x & 127;
  row = wg * 64 + (tid >> 1);
  zero(res);
  const int g0 = (tid & 1) * (width / 16);
  for (int g = g0; g < g0 + width / 16; ++g) {
    const uint4 v = *reinterpret_cast<const uint4*>(
        act_p + (g >> 3) * PANEL_BYTES + row * 128
        + (((g & 7) ^ (row & 7)) << 4));
    const bf16* hv = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float h = to_f32(hv[e]);
      const bf16* w = w_out + (8 * g + e) * n_out;
#pragma unroll
      for (int o = 0; o < 4; ++o)
        if (o < n_out) res[o] = fmaf(h, to_f32(w[o]), res[o]);
    }
  }
#pragma unroll
  for (int o = 0; o < 4; ++o)
    res[o] += __shfl_xor_sync(0xffffffffu, res[o], 1);
}

// Shared-memory layout of a bf16 block: the buffers, then `n_stage` weight
// stages, the two tile slots, f32 rows and the barriers. `base` is the
// dynamic shared memory rounded up to 1024 bytes (the swizzle's period).
struct Layout {
  unsigned char* base;
  uint32_t sbase;
  __device__ static Layout make(unsigned char* raw) {
    const uint32_t a = smem_addr(raw);
    const uint32_t pad = ((a + 1023u) & ~1023u) - a;
    return Layout{raw + pad, a + pad};
  }
};

// ===========================================================================
// The float32 layer primitive
// ===========================================================================
//
// A block works on TM = 64 samples (half a liveness tile) with 256 threads
// and plain f32 fmaf (no TF32): the JAX kernel's Precision.HIGHEST.
//
//   * Activations live in shared memory feature-major: row k of a buffer
//     holds feature k of the block's 64 samples, F_LD floats apart (the
//     4-float pad moves each row to the next 16-byte bank group).
//   * A thread owns 8 samples x CS columns of a product (CS = N / 32 for a
//     hidden layer): per k step it reads its samples as two float4 and its
//     weights as float4 (or float2) from shared memory and makes 8 CS fmaf,
//     4 of them per 32-bit word read. Thread (sg, cg) takes samples
//     8 sg .. 8 sg + 7 and columns q VEC ncg + VEC cg + v; a quarter warp
//     holds four sample groups and two column groups, so that neither its
//     activation nor its weight loads meet a bank conflict.
//   * Weights stream from device memory in chunks of KC rows (KC x N
//     floats, contiguous in the (K, N) row-major matrix) through a ring of
//     F_STAGES stages with cp.async: the next chunks are in flight while
//     the current one is multiplied, and each weight byte leaves L2 once a
//     block.
//   * The backward's dW = A^T dy sums over the block's samples, so both of
//     its operands are read along the sample axis: 4 samples as one float4
//     a row, rows of a thread 8 apart (bank-conflict free), and the sums
//     leave as one 16-byte (or 8-byte) vector atomic per 4 (2) columns.

constexpr int F_THREADS = 256;
constexpr int F_LD = TM + 4;               // floats a feature row
constexpr int KC = 16;                     // weight rows a chunk
constexpr int F_STAGES = 3;
constexpr int F_STAGE_FLOATS = KC * MAX_WIDTH;
constexpr int F_ACT_FLOATS = MAX_WIDTH * F_LD;
constexpr int F_EMB_FLOATS = MAX_EPAD * F_LD;

// this thread's sample group (0..7) and column group (0..31)
__device__ __forceinline__ int f_sg() {
  return ((threadIdx.x >> 7) << 2) | (threadIdx.x & 3);
}
__device__ __forceinline__ int f_cg() {
  return (((threadIdx.x >> 5) & 3) << 3) | ((threadIdx.x >> 2) & 7);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Column layout of a thread's CS columns: Q groups of VEC neighbours.
template <int CS> struct FCols {
  static constexpr int VEC = CS % 4 == 0 ? 4 : 2;
  static constexpr int Q = CS / VEC;
};

// wv[q VEC + v] = row[q VEC ncg + v], row already offset by VEC cg
template <int CS>
__device__ __forceinline__ void load_cols(float (&wv)[CS], const float* row,
                                          int ncg) {
  constexpr int VEC = FCols<CS>::VEC;
#pragma unroll
  for (int q = 0; q < FCols<CS>::Q; ++q) {
    if constexpr (VEC == 4) {
      const float4 t = *reinterpret_cast<const float4*>(row + q * 4 * ncg);
      wv[4 * q] = t.x; wv[4 * q + 1] = t.y;
      wv[4 * q + 2] = t.z; wv[4 * q + 3] = t.w;
    } else {
      const float2 t = *reinterpret_cast<const float2*>(row + q * 2 * ncg);
      wv[2 * q] = t.x; wv[2 * q + 1] = t.y;
    }
  }
}

template <int CS> __device__ __forceinline__ void zero(float (&d)[8][CS]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < CS; ++c) d[j][c] = 0.0f;
}

// acc (this thread's 8 samples x CS columns) += A W over K: A feature-major
// in shared memory (K rows), W (K, N) row-major in device memory, K a
// multiple of KC, N = CS ncg with ncg <= 32 (threads with cg >= ncg only
// help with the copies). Ends with a block barrier, after which A and the
// ring may be overwritten.
template <int CS>
__device__ void gemm_f32(float (&acc)[8][CS], const float* A,
                         const float* __restrict__ W, int N, int K,
                         float* ring) {
  constexpr int VEC = FCols<CS>::VEC;
  const int ncg = N / CS;
  const int sg = f_sg(), cg = f_cg();
  const bool active = cg < ncg;
  const int chunk = KC * N;
  const int nchunks = K / KC;
  auto issue = [&](int c) {
    if (c < nchunks) {
      const float* src = W + (size_t)c * chunk;
      float* dst = ring + (c % F_STAGES) * F_STAGE_FLOATS;
      for (int i = threadIdx.x * 4; i < chunk; i += F_THREADS * 4)
        cp_async16(dst + i, src + i);
    }
    cp_async_commit();   // empty groups too: the wait below counts groups
  };
#pragma unroll
  for (int c = 0; c < F_STAGES - 1; ++c) issue(c);
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<F_STAGES - 2>();
    __syncthreads();     // chunk c is in for everyone; chunk c - 1 is done
    issue(c + F_STAGES - 1);
    if (active) {
      const float* w = ring + (c % F_STAGES) * F_STAGE_FLOATS + VEC * cg;
      const float* a = A + (size_t)c * KC * F_LD + 8 * sg;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(a + kk * F_LD);
        const float4 a1 = *reinterpret_cast<const float4*>(a + kk * F_LD + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float wv[CS];
        load_cols<CS>(wv, w + kk * N, ncg);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c2 = 0; c2 < CS; ++c2)
            acc[j][c2] = fmaf(av[j], wv[c2], acc[j][c2]);
      }
    }
  }
  __syncthreads();
}

// Epilogue of a hidden layer: h = relu(acc + b) written feature-major into
// dst (which may be the layer's input: gemm_f32 ended with a barrier) and,
// where `copy` is not null, into copy as (N, TM) rows in device memory.
template <int CS>
__device__ __forceinline__ void store_relu(const float (&acc)[8][CS],
                                           const float* __restrict__ bias,
                                           int N, float* dst, float* copy) {
  constexpr int VEC = FCols<CS>::VEC;
  const int ncg = N / CS;
  const int sg = f_sg(), cg = f_cg();
#pragma unroll
  for (int q = 0; q < FCols<CS>::Q; ++q)
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int c = q * VEC * ncg + VEC * cg + v;
      const float b = __ldg(bias + c);
      const float4 h0 = make_float4(
          fmaxf(acc[0][q * VEC + v] + b, 0.0f), fmaxf(acc[1][q * VEC + v] + b, 0.0f),
          fmaxf(acc[2][q * VEC + v] + b, 0.0f), fmaxf(acc[3][q * VEC + v] + b, 0.0f));
      const float4 h1 = make_float4(
          fmaxf(acc[4][q * VEC + v] + b, 0.0f), fmaxf(acc[5][q * VEC + v] + b, 0.0f),
          fmaxf(acc[6][q * VEC + v] + b, 0.0f), fmaxf(acc[7][q * VEC + v] + b, 0.0f));
      float* d = dst + c * F_LD + 8 * sg;
      *reinterpret_cast<float4*>(d) = h0;
      *reinterpret_cast<float4*>(d + 4) = h1;
      if (copy != nullptr) {
        float* g = copy + (size_t)c * TM + 8 * sg;
        *reinterpret_cast<float4*>(g) = h0;
        *reinterpret_cast<float4*>(g + 4) = h1;
      }
    }
}

// One net's hidden layers at CS = width / 32; the last h is left in act.
// store: where every layer's output is copied ((depth, width, TM) in device
// memory), or null.
template <int CS>
__device__ void layers_f32(const NetDesc& net, float* act, const float* emb,
                           float* ring, float* store) {
  for (int li = 0; li < net.depth; ++li) {
    float acc[8][CS];
    zero(acc);
    if (net.w_h[li] != nullptr)
      gemm_f32<CS>(acc, act, static_cast<const float*>(net.w_h[li]),
                   net.width, net.width, ring);
    if (net.w_e[li] != nullptr)
      gemm_f32<CS>(acc, emb, static_cast<const float*>(net.w_e[li]),
                   net.width, net.epad, ring);
    store_relu<CS>(acc, net.b[li], net.width, act,
                   store != nullptr
                       ? store + (size_t)li * net.width * TM : nullptr);
    __syncthreads();
  }
}

__device__ void run_net_f32(const NetDesc& net, float* act, const float* emb,
                            float* ring, float* store) {
  switch (net.width / 64) {
    case 1: layers_f32<2>(net, act, emb, ring, store); break;
    case 2: layers_f32<4>(net, act, emb, ring, store); break;
    case 3: layers_f32<6>(net, act, emb, ring, store); break;
    default: layers_f32<8>(net, act, emb, ring, store); break;
  }
}

// Fourier embedding of pts (TM, 3) into emb, feature-major, rows < epad
// (past the used columns: 0). lead3: the canonical embed starts with the
// point itself; hann: per-frequency window weight (non-rigid embed) or null.
__device__ void embed_f32(const float* pts, int multires, int epad,
                          bool lead3, const float* hann, float* emb) {
  const int lead = lead3 ? 3 : 0;
  for (int idx = threadIdx.x; idx < TM * epad; idx += F_THREADS) {
    const int c = idx / TM;
    const int r = idx - c * TM;
    float v = 0.0f;
    if (c < lead) {
      v = pts[r * 3 + c];
    } else if (c < lead + 6 * multires) {
      const int j = c - lead;
      const int f = j / 6;
      const int q = j - 6 * f;
      const int d = q >= 3 ? q - 3 : q;
      const float s = pts[r * 3 + d] * (float)(1 << f);
      v = q >= 3 ? cosf(s) : sinf(s);
      if (hann != nullptr) v *= hann[f];
    }
    emb[c * F_LD + r] = v;
  }
}

// Narrow output layer: h (feature-major) row r dot column o of w_out (width,
// n_out), plus b.
__device__ __forceinline__ float out_f32(const float* h, int width, int n_out,
                                         const float* __restrict__ w_out,
                                         int r, int o, float b) {
  float acc = 0.0f;
  for (int k = 0; k < width; ++k)
    acc = fmaf(h[k * F_LD + r], __ldg(w_out + k * n_out + o), acc);
  return acc + b;
}

// Host side: descriptor tables handed over by the Python wrapper.
inline void fill_net(NetDesc& d, const int* desc, const void* const* ptrs) {
  d.depth = desc[0];
  d.width = desc[1];
  d.multires = desc[2];
  d.epad = desc[3];
  d.n_out = desc[4];
  for (int i = 0; i < MAX_DEPTH; ++i) {
    d.w_h[i] = ptrs[i];
    d.w_e[i] = ptrs[MAX_DEPTH + i];
    d.b[i] = static_cast<const float*>(ptrs[2 * MAX_DEPTH + i]);
  }
  d.w_out = ptrs[3 * MAX_DEPTH];
  d.b_out = static_cast<const float*>(ptrs[3 * MAX_DEPTH + 1]);
}

inline bool net_ok(const NetDesc& d, int n_out) {
  return d.depth >= 1 && d.depth <= MAX_DEPTH && d.width >= 64 &&
         d.width <= MAX_WIDTH && d.width % 64 == 0 && d.multires >= 0 &&
         d.multires <= MAX_FREQ && d.epad % 16 == 0 && d.epad >= 16 &&
         d.epad <= MAX_EPAD && d.n_out == n_out;
}

}  // namespace
