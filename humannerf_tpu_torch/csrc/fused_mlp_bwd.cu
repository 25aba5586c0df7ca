// Backward of the fused non-rigid + canonical MLP point query, for sm_90a.
//
// Replaces the Pallas TPU kernel humannerf_tpu/ops/pallas_mlp.py
// (`_bwd_call` -> `_bwd_kernel` / `_bwd_block`). Given the cotangent g (N, 4)
// of raw it recomputes the forward of fused_mlp.cu for a tile of samples,
// keeping every layer's activations, then walks the layers backwards:
//
//   dy = dh * (h > 0);  dW += h_prev^T dy;  db += sum dy;  dh_prev = dy W^T
//
// with the skip layers as two products, the canonical embedding Jacobian
// (d embed / d xyz), xyz = x + offset feeding both the identity path and the
// non-rigid output layer, and the hann-windowed non-rigid embedding Jacobian.
// It writes dx (N, 3) and adds into one f32 buffer per weight and bias. A
// tile whose liveness flag is 0 writes dx = 0 and does nothing else: its
// cotangent is exactly zero, so the skip is exact.
//
// What bounds it: three products a layer (recompute, dy W^T, h^T dy), about
// 3.5 MFLOP against 44 bytes a live sample, so tensor-core operations, as
// the forward.
//
// What the bf16 design does about it: the forward's Hopper primitive
// (fused_mlp_common.cuh: persistent grid, weight k-chunks streamed with
// cp.async.bulk, two consumer warpgroups on wgmma, one 128-sample tile a
// block), with these differences:
//   * No producer warp: 256 threads. A block of 288 or 384 threads gets 168
//     registers a thread, which the backward's 128-register accumulators,
//     its relu masks and its state overflow; ptxas then spills and
//     serialises every wgmma (its C7512 / C7520 remarks). Warpgroup 0
//     refills the two-stage ring as it hands stages back (FedRing), from a
//     per-tile chunk schedule in shared memory, and warp 0 fetches the next
//     tile one tile ahead. The refill is one predicated asm block: a bulk
//     copy issued on a branch of its own between wgmma issues also makes
//     ptxas serialise them.
//   * The forward recompute runs through the forward's layer; after each
//     layer's epilogue a warpgroup copies its rows to the block's scratch in
//     device memory with bulk stores (14 layers x 128 rows are 720 KB at the
//     default widths: more than shared memory). 132 blocks hold 95 MB of
//     scratch, about twice the 50 MB L2, so the scratch does not stay in L2:
//     a layer is written and read back once a tile (2 x 720 KB), overlapped
//     with the products. Reading h_prev back for layer l - 1 starts while
//     layer l's dy W^T runs (the relu mask it needs is taken into registers
//     first), so only the first load of a net waits.
//   * dh_prev = dy W^T and the embedding's dE += dy W_e^T run on wgmma with
//     dy (A, K-major) and the same packed weight chunks read as an MN-major
//     B: no transposed copy of the weights exists in bf16. dE is summed in
//     a few KB of the scratch, so no register holds it across the layers.
//   * dW = h_prev^T dy is a wgmma with A = h_prev and B = dy, both MN-major
//     in shared memory, K = the tile's 128 samples; the two warpgroups take
//     its 64-row M-tiles in turn and add them into the f32 gradient buffers
//     with 16-byte vector atomics (two lanes trade halves so that a lane
//     holds four neighbouring columns). The order of these sums, and with
//     it the last bits of dW, varies from run to run.
//   * db is summed from the rounded dy in the epilogue that writes it (lane
//     shuffles, then shared atomics, then one global atomic a column).
// What still bounds it: the ring has two stages (the scratch and the
// backward's two activation buffers leave no room for more), so a chunk's
// L2 latency is hidden only behind one chunk of products; and the dW
// atomics, 0.6 M floats a live tile.
// f32 mode keeps the fmaf kernel: 64 samples a block, activations in a
// per-block scratch, dW by scalar atomics.
//
// ptxas -v (sm_90a, CUDA 12.8), bf16 kernel: 255 registers, 346 B of spill
// stores, 288 B of stack; 230 216 B of dynamic shared memory a block (two
// 64 KB activation buffers, 16 KB embedding, 2 x 32 KB weight stages, tile
// slots, chunk schedule, barriers).
//
// Numerics: bf16 mode rounds both operands of every product to bf16 (dy and
// the cotangents included) and accumulates in f32, as the forward; the relu
// mask is taken from the stored (rounded) activation; dW is returned in f32
// unrounded. f32 mode is fmaf only.

#include "fused_mlp_common.cuh"

namespace {

struct BwdNet {
  NetDesc net;                      // the forward's operands
  // f32: (out, in) copies for dh = dy W^T (null in bf16)
  const void* w_h_t[MAX_DEPTH];
  const void* w_e_t[MAX_DEPTH];
  float* dw_h[MAX_DEPTH];           // (width, width), (in, out)
  float* dw_e[MAX_DEPTH];           // (epad, width), (in, out)
  float* db[MAX_DEPTH];             // (width,)
  float* dw_out;                    // (width, n_out)
  float* db_out;                    // (n_out,)
};

struct BwdParams {
  const float* x;       // (n, 3)
  const float* g;       // (n, 4) cotangent of raw
  float* dx;            // (n, 3)
  long long n;
  const int* live;      // (ceil(n / TILE),)
  int* next_tile;       // bf16: tile counter of the persistent grid, zeroed
  float hann[MAX_FREQ];
  int skip_nr;
  void* scratch;                    // per resident block: all activations
  long long scratch_elems;          // elements of the compute type per block
  BwdNet nr;
  BwdNet cnl;
};

template <typename T>
constexpr size_t bwd_smem_bytes() {
  return sizeof(T) * (2 * TM * Cfg<T>::H_LD + TM * Cfg<T>::E_LD)
       + sizeof(float) * (Cfg<T>::STAGE_FLOATS + TM * DE_LD + TM * 13);
}

// Operand rounding of the compute type, result kept in f32.
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<T>(v));
}

// TM rows of `width` elements between shared memory and the scratch area,
// as 16-byte words.
template <typename T>
__device__ void copy_rows(const T* src, int src_ld, T* dst, int dst_ld,
                          int width) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = width / V;
  for (int idx = threadIdx.x; idx < TM * per_row; idx += Cfg<T>::THREADS) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * V;
    *reinterpret_cast<int4*>(dst + r * dst_ld + c) =
        *reinterpret_cast<const int4*>(src + r * src_ld + c);
  }
}

// One net's hidden layers as in the forward kernel, with every layer's output
// also copied to `scratch` ((depth, TM, width)). Returns the last h's buffer.
template <typename T>
__device__ T* forward_store(const NetDesc& net, const T* emb, T* buf_a,
                            T* buf_b, float* stage, T* scratch) {
  constexpr int H_LD = Cfg<T>::H_LD;
  T* cur = buf_a;
  T* nxt = buf_b;
  dense<T>(nullptr, 0, nullptr, emb, net.epad, net.w_e[0], net.b[0],
           net.width, cur, stage);
  __syncthreads();
  copy_rows<T>(cur, H_LD, scratch, net.width, net.width);
  for (int li = 1; li < net.depth; ++li) {
    dense<T>(cur, net.width, net.w_h[li], emb, net.epad, net.w_e[li],
             net.b[li], net.width, nxt, stage);
    __syncthreads();
    copy_rows<T>(nxt, H_LD, scratch + (size_t)li * TM * net.width, net.width,
                 net.width);
    T* t = cur; cur = nxt; nxt = t;
  }
  return cur;
}

// dW += A^T D over the block's TM samples. A (TM, rows_in) with stride lda is
// the layer's input (h_prev or the embedding), D (TM, width_out) is dy.
__device__ void wgrad(const float* A, int lda, int rows_in, const float* D,
                      int width_out, float* dW, float* /*stage*/) {
  constexpr int H_LD = Cfg<float>::H_LD;
  // a thread owns 4 input rows at one output column: one broadcast float4 of
  // A and one D value a sample (measured faster than one row at 4 columns
  // with a vector atomic: 101 vs 112 ms a call at the training shape)
  const int items = (rows_in / 4) * width_out;
  for (int it = threadIdx.x; it < items; it += Cfg<float>::THREADS) {
    const int r4 = (it / width_out) * 4;
    const int c = it % width_out;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    for (int s = 0; s < TM; ++s) {
      const float d = D[s * H_LD + c];
      const float4 a = *reinterpret_cast<const float4*>(A + s * lda + r4);
      a0 = fmaf(a.x, d, a0);
      a1 = fmaf(a.y, d, a1);
      a2 = fmaf(a.z, d, a2);
      a3 = fmaf(a.w, d, a3);
    }
    float* o = dW + (size_t)r4 * width_out + c;
    atomicAdd(o, a0);
    atomicAdd(o + width_out, a1);
    atomicAdd(o + 2 * width_out, a2);
    atomicAdd(o + 3 * width_out, a3);
  }
}

// db += column sums of D.
template <typename T>
__device__ void bgrad(const T* D, int width, float* db) {
  for (int c = threadIdx.x; c < width; c += Cfg<T>::THREADS) {
    float acc = 0.0f;
    for (int s = 0; s < TM; ++s) acc += to_f32(D[s * Cfg<T>::H_LD + c]);
    atomicAdd(db + c, acc);
  }
}

// dE += D W_e^T: the embedding's share of a layer's input gradient, kept in
// f32 in shared memory. w_t is W_e stored (out, epad).
__device__ void egrad(const float* D, int width, const void* w_t_, int epad,
                      float* dE) {
  constexpr int H_LD = Cfg<float>::H_LD;
  const float* __restrict__ w_t = static_cast<const float*>(w_t_);
  for (int idx = threadIdx.x; idx < TM * epad; idx += Cfg<float>::THREADS) {
    const int s = idx / epad;
    const int e = idx - s * epad;
    float acc = dE[s * DE_LD + e];
    for (int o = 0; o < width; ++o)
      acc = fmaf(D[s * H_LD + o], w_t[(size_t)o * epad + e], acc);
    dE[s * DE_LD + e] = acc;
  }
}

// H <- (D W^T) * (H > 0), in place: the next dy from this layer's dy. w_t is
// the layer's w_h stored (out, in); all widths are equal.
template <int CPT>
__device__ void dgrad_fma(const float* D, int width,
                          const float* __restrict__ w_t, float* H) {
  constexpr int H_LD = Cfg<float>::H_LD;
  const int r0 = (threadIdx.x >> 5) * 8;
  const int c0 = (threadIdx.x & 31) * CPT;
  float acc[8][CPT];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[r][j] = 0.0f;
  for (int k = 0; k < width; ++k) {
    float wv[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) wv[j] = w_t[(size_t)k * width + c0 + j];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float dv = D[(r0 + r) * H_LD + k];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[r][j] = fmaf(dv, wv[j], acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      float* h = H + (r0 + r) * H_LD + c0 + j;
      *h = *h > 0.0f ? acc[r][j] : 0.0f;
    }
}

__device__ void dgrad(const float* D, int width, const void* w_t, float* H,
                      float* /*stage*/) {
  const float* w = static_cast<const float*>(w_t);
  switch (width / 64) {
    case 1: dgrad_fma<2>(D, width, w, H); break;
    case 2: dgrad_fma<4>(D, width, w, H); break;
    case 3: dgrad_fma<6>(D, width, w, H); break;
    default: dgrad_fma<8>(D, width, w, H); break;
  }
}

// ---------------------------------------------------------------------------
// bf16: the Hopper kernel
// ---------------------------------------------------------------------------

constexpr int K2_STAGES = 2;
constexpr int MAX_CHUNKS = 2 * 2 * MAX_DEPTH * (MAX_WIDTH / 64 + 1);
constexpr int K2_D_OFF = ACT_BYTES;
constexpr int K2_EMB_OFF = 2 * ACT_BYTES;
constexpr int K2_STAGE_OFF = K2_EMB_OFF + EMB_BYTES;
constexpr int K2_SLOTS_OFF = K2_STAGE_OFF + K2_STAGES * CHUNK_MAX_BYTES;
constexpr int K2_XYZ_OFF = K2_SLOTS_OFF + 2 * (int)sizeof(TileSlot);
constexpr int K2_DXYZ_OFF = K2_XYZ_OFF + TILE * 3 * 4;
constexpr int K2_DB_OFF = K2_DXYZ_OFF + TILE * 3 * 4;
constexpr int K2_SCHED_OFF = K2_DB_OFF + 2 * MAX_WIDTH * 4;
constexpr int K2_BAR_OFF = K2_SCHED_OFF + MAX_CHUNKS * 16;
constexpr size_t K2_SMEM = 1024 + K2_BAR_OFF + (2 * K2_STAGES + 1) * 8;

// One weight chunk of the per-tile schedule.
struct Chunk {
  const void* src;
  uint32_t bytes;
  uint32_t pad;
};

// Counts (and, given `out`, records) the chunk order of stream_forward /
// stream_backward.
struct Recorder {
  Chunk* out;
  int n;
  __device__ void load(const void* src, uint32_t bytes) {
    if (out != nullptr) out[n] = Chunk{src, bytes, 0};
    ++n;
  }
};

// The weight ring without a producer warp. Warpgroup 0 refills it: when it
// hands chunk k's stage back, all its threads wait until the other
// warpgroup has too, and thread 0 issues chunk k + nstage of the per-tile
// schedule into it. Every thread keeps the same counts, so no loop runs on
// one thread alone (a thread-divergent path between wgmma issues makes
// ptxas serialise them). `avail`: chunks the tiles known to this block
// need, so that nothing is loaded that no tile reads.
struct FedRing : Ring {
  const Chunk* sched;
  int len, released, avail, wg;
  // chunk k into stage s, by thread 0 of the calling threads: one
  // predicated asm block, no branch (a bulk copy on a path of its own
  // between wgmma issues makes ptxas serialise them)
  __device__ void issue(int k, int s) const {
    const Chunk& c = sched[k % len];
    const uint32_t bar = full + 8 * s;
    asm volatile(
        "{\n.reg .pred p;\nsetp.eq.u32 p, %4, 0;\n"
        "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
        "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%2], [%3], %1, [%0];\n}\n" ::"r"(bar), "r"(c.bytes),
        "r"(data + s * CHUNK_MAX_BYTES), "l"(c.src), "r"(threadIdx.x)
        : "memory");
  }
  __device__ void release(int s) {
    Ring::release(s);
    const int k = released++ + nstage;
    if (wg == 0 && k < avail) {
      mbar_wait(empty + 8 * s, ((uint32_t)(k / nstage) & 1u) ^ 1u);
      issue(k, s);
    }
  }
};

// The shared buffers of the backward: h (the layer below the one being
// differentiated; also the forward's activations), dy, the embedding, and
// the two warpgroups' column sums of dy.
struct BwdBufs {
  uint32_t h, d, emb;
  unsigned char* h_p;
  unsigned char* d_p;
  unsigned char* emb_p;
  float* db_part;       // (2, MAX_WIDTH)
};

// One stored layer brought back into the h buffer: issued by consumer
// thread 0, awaited by every consumer thread.
struct HLoad {
  uint32_t bar, dst;
  uint32_t phase;
  __device__ void load(const unsigned char* src, uint32_t bytes) const {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, bytes);
      bulk_load(dst, src, bytes, bar);
    }
  }
  __device__ void wait() {
    mbar_wait(bar, phase);
    phase ^= 1;
  }
};

// One net's weight chunks in the order its backward consumes them: per
// layer from the last, w_e's chunk (if any, for dE) then w_h's (for dh).
template <class Sink>
__device__ void stream_backward(const NetDesc& net, Sink& f) {
  const uint32_t cb = net.width * 128;
  for (int li = net.depth - 1; li >= 1; --li) {
    if (net.w_e[li] != nullptr) f.load(net.w_e[li], cb);
    for (int c = 0; c < net.width / 64; ++c)
      f.load(static_cast<const unsigned char*>(net.w_h[li]) + c * cb, cb);
  }
  f.load(net.w_e[0], cb);
}

// dst += the 64 x (64 P) f32 tile in the accumulator layout, rows below
// `rows` only, as 16-byte vector atomics: lanes l and l ^ 1 trade halves so
// that each holds four neighbouring columns of one row.
template <int P>
__device__ __forceinline__ void add_rows(float (&acc)[P][32], float* dst,
                                         int rows) {
  const int lane = threadIdx.x & 31;
  const bool odd = lane & 1;
  const int r = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2) + (odd ? 8 : 0);
  const int c0 = 2 * (lane & 3) - (odd ? 2 : 0);
#pragma unroll
  for (int q = 0; q < P; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* d = &acc[q][4 * j];
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? d[0] : d[2], 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? d[1] : d[3], 1);
      const float4 v = odd ? make_float4(r0, r1, d[2], d[3])
                           : make_float4(d[0], d[1], r0, r1);
      if (r < rows)
        atomicAdd(reinterpret_cast<float4*>(
                      dst + (size_t)r * (64 * P) + 64 * q + 8 * j + c0), v);
    }
}

// dW += A^T dy over the tile's 128 samples, A MN-major from shared memory
// (the h buffer's P panels if with_h, then the embedding if with_e), B = dy
// MN-major. The M-tiles are dealt to the two warpgroups in turn; both run
// the same number of rounds (where the count is odd one warpgroup redoes
// the last tile and adds nothing), so that no wgmma sits on a path that
// depends on the warpgroup.
template <int P>
__device__ __forceinline__ void dw_phase(const BwdBufs& b, bool with_h,
                                         bool with_e, float* dw_h,
                                         float* dw_e, int epad, int wg) {
  const int n_m = (with_h ? P : 0) + (with_e ? 1 : 0);
  for (int i = 0; i < (n_m + 1) / 2; ++i) {
    const bool extra = 2 * i + wg >= n_m;
    const int m = extra ? n_m - 1 : 2 * i + wg;
    const bool is_e = !with_h || m == P;
    const uint32_t a = is_e ? b.emb : b.h + m * PANEL_BYTES;
    float acc[P][32];
#pragma unroll
    for (int q = 0; q < P; ++q) zero(acc[q]);
    wgmma_fence();
    // one m64nNk16 a k-step over all of dy's panels (64-column blocks
    // PANEL_BYTES apart); acc[q] is the accumulator's q-th 64 columns
#pragma unroll 1
    for (int ks = 0; ks < TILE / 16; ++ks)
      Wgmma<64 * P, 1, 1>::mma(reinterpret_cast<float(&)[32 * P]>(acc),
                               mnmajor(a + ks * 2048),
                               mnmajor(b.d + ks * 2048));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < P; ++q) fence_regs(acc[q]);
    add_rows<P>(acc, is_e ? dw_e : dw_h + (size_t)m * 64 * (64 * P),
                extra ? 0 : is_e ? epad : 64);
  }
}

// Bit (4j + 2hh + e) of mask[c]: h > 0 where this thread's dh accumulator
// element (n64 block c, n8 block j, row half hh, column e) lands.
template <int P>
__device__ __forceinline__ void read_mask(const unsigned char* h_p,
                                          uint32_t (&mask)[P], int wg) {
  const int lane = threadIdx.x & 31;
  const int r = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int c = 0; c < P; ++c) {
    mask[c] = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 h = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(
                h_p + c * PANEL_BYTES + (r + 8 * hh) * 128
                + ((j ^ (lane >> 2)) << 4) + (lane & 3) * 4));
        const int bit = 4 * j + 2 * hh;
        if (h.x > 0.0f) mask[c] |= 1u << bit;
        if (h.y > 0.0f) mask[c] |= 2u << bit;
      }
  }
}

// dy of the layer below = dh * (h > 0), rounded to bf16 and written over dy
// in place (this warpgroup's rows); its column sums (of the rounded values)
// go to the warpgroup's db_part row.
template <int P>
__device__ __forceinline__ void dh_epilogue(float (&acc)[P][32],
                                            const uint32_t (&mask)[P],
                                            const BwdBufs& b, int wg) {
  const int lane = threadIdx.x & 31;
  const int r = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  float* part = b.db_part + wg * MAX_WIDTH;
#pragma unroll
  for (int c = 0; c < P; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int bit = 4 * j + 2 * hh;
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            (mask[c] >> bit) & 1u ? acc[c][4 * j + 2 * hh] : 0.0f,
            (mask[c] >> (bit + 1)) & 1u ? acc[c][4 * j + 2 * hh + 1] : 0.0f);
        *reinterpret_cast<__nv_bfloat162*>(
            b.d_p + c * PANEL_BYTES + (r + 8 * hh) * 128
            + ((j ^ (lane >> 2)) << 4) + (lane & 3) * 4) = v;
        const float2 f = __bfloat1622float2(v);
        s0 += f.x;
        s1 += f.y;
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      if (lane < 4) {
        atomicAdd(part + 64 * c + 8 * j + cq, s0);
        atomicAdd(part + 64 * c + 8 * j + cq + 1, s1);
      }
    }
}

// db += the two warpgroups' column sums of dy; clears them.
__device__ void flush_db(float* part, float* db, int width) {
  const int c = threadIdx.x;
  if (c < width) {
    atomicAdd(db + c, part[c] + part[MAX_WIDTH + c]);
    part[c] = 0.0f;
    part[MAX_WIDTH + c] = 0.0f;
  }
}

// The output layer backward for this warpgroup's rows: dW_out += h^T g,
// db_out += sum g, and dy of the last hidden layer = (g W_out^T) * (h > 0)
// into the dy buffer, its column sums into db_last. g (TILE, n_out) f32 is
// rounded to bf16 as an operand. A thread takes two neighbouring columns
// over the 64 rows.
template <int P>
__device__ void out_bwd(const BwdBufs& b, const float* gsrc, int n_out,
                        const bf16* __restrict__ w_out, float* dw_out,
                        float* db_out, float* db_last, int wg) {
  const int tid = threadIdx.x & 127;
  const int c = 2 * tid;
  if (c < 64 * P) {
    float wo[2][4], dwo[2][4];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        wo[e][o] = o < n_out ? to_f32(w_out[(c + e) * n_out + o]) : 0.0f;
        dwo[e][o] = 0.0f;
      }
    float db0 = 0.0f, db1 = 0.0f;
    for (int rl = 0; rl < 64; ++rl) {
      const int r = wg * 64 + rl;
      const uint32_t off = swz(r, c);
      const float2 h = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(b.h_p + off));
      float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        if (o < n_out) {
          const float gr = to_f32(from_f32<bf16>(gsrc[r * n_out + o]));
          dwo[0][o] = fmaf(h.x, gr, dwo[0][o]);
          dwo[1][o] = fmaf(h.y, gr, dwo[1][o]);
          a0 = fmaf(gr, wo[0][o], a0);
          a1 = fmaf(gr, wo[1][o], a1);
        }
      }
      const __nv_bfloat162 dv = __floats2bfloat162_rn(h.x > 0.0f ? a0 : 0.0f,
                                                      h.y > 0.0f ? a1 : 0.0f);
      *reinterpret_cast<__nv_bfloat162*>(b.d_p + off) = dv;
      const float2 df = __bfloat1622float2(dv);
      db0 += df.x;
      db1 += df.y;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 0; o < 4; ++o)
        if (o < n_out) atomicAdd(dw_out + (c + e) * n_out + o, dwo[e][o]);
    atomicAdd(db_last + c, db0);
    atomicAdd(db_last + c + 1, db1);
  }
  if (tid < n_out) {
    float a = 0.0f;
    for (int rl = 0; rl < 64; ++rl) a += gsrc[(wg * 64 + rl) * n_out + tid];
    atomicAdd(db_out + tid, a);
  }
}

// acc += dy W^T for this warpgroup's rows, W^T's 64 columns of one chunk:
// dy is A (K-major, K = the layer's width), the chunk B read MN-major.
template <int N>
__device__ __forceinline__ void dgrad_chunk(float (&acc)[32], uint32_t d,
                                            uint32_t w, int wg) {
  const uint32_t rows = wg * 64 * 128;
  wgmma_fence();
#pragma unroll 1
  for (int ks = 0; ks < N / 16; ++ks)
    Wgmma<64, 0, 1>::mma(
        acc, kmajor(d + (ks >> 2) * PANEL_BYTES + rows + (ks & 3) * 32),
        mnmajor(w + ks * 2048));
  wgmma_commit();
}

// de += dy W_e^T from the ring's next chunk (the embedding's share of a
// layer's input gradient), in an accumulator of its own that is done
// before it is added. de: this thread's 32 f32 sums in the block's scratch
// (device memory, only ever touched by this thread), so that no register
// holds them across the layers; `first` overwrites them.
template <int N>
__device__ __forceinline__ void egrad_chunk(FedRing& rg, uint32_t d, int wg,
                                            float* de, bool first) {
  float acc[32];
  zero(acc);
  dgrad_chunk<N>(acc, d, rg.wait(), wg);
  wgmma_wait<0>();
  fence_regs(acc);
  rg.release(rg.stage);
  rg.next();
  float4* q = reinterpret_cast<float4*>(de);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float4 v = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                           acc[4 * i + 3]);
    if (!first) {
      const float4 o = q[i];
      v.x += o.x;
      v.y += o.y;
      v.z += o.z;
      v.w += o.w;
    }
    q[i] = v;
  }
}

// One net backwards, both warpgroups together. On entry the embedding
// buffer holds the net's input embedding, gsrc (TILE, n_out) f32 the
// cotangent of the net's output, and the h buffer the last hidden layer's
// output if h_last_loaded (else it is read back from the scratch). Leaves
// in de (this thread's 32 floats of device memory) its share of the
// gradient with respect to the embedding, in the accumulator layout of
// this warpgroup's 64 rows x 64 columns.
template <int P>
__device__ __forceinline__ void backward_net_h(
    const BwdNet& bn, FedRing& rg, HLoad& hl, const BwdBufs& b,
    const float* gsrc, const unsigned char* scratch, bool h_last_loaded,
    int wg, float* de) {
  constexpr int N = 64 * P;
  const NetDesc& net = bn.net;
  const int depth = net.depth;
  const uint32_t layer_bytes = TILE * N * 2;
  if (!h_last_loaded) {
    hl.load(scratch + (size_t)(depth - 1) * layer_bytes, layer_bytes);
    hl.wait();
  }
  out_bwd<P>(b, gsrc, net.n_out, static_cast<const bf16*>(net.w_out),
             bn.dw_out, bn.db_out, bn.db[depth - 1], wg);
  fence_async_smem();
  consumers_sync();
  if (depth >= 2) {
    hl.load(scratch + (size_t)(depth - 2) * layer_bytes, layer_bytes);
    hl.wait();
  }
  bool first = true;
  for (int li = depth - 1; li >= 1; --li) {
    // h holds h_{li-1}, dy holds layer li's dy
    const bool skip = net.w_e[li] != nullptr;
    dw_phase<P>(b, true, skip, bn.dw_h[li], bn.dw_e[li], net.epad, wg);
    uint32_t mask[P];
    read_mask<P>(b.h_p, mask, wg);
    fence_async_smem();
    consumers_sync();
    // h is free: bring back h_{li-2} while dh = dy W^T runs
    if (li >= 2)
      hl.load(scratch + (size_t)(li - 2) * layer_bytes, layer_bytes);
    if (skip) {
      egrad_chunk<N>(rg, b.d, wg, de, first);
      first = false;
    }
    float acc[P][32];
#pragma unroll
    for (int c = 0; c < P; ++c) zero(acc[c]);
    int prev = -1;
#pragma unroll
    for (int c = 0; c < P; ++c) {
      dgrad_chunk<N>(acc[c], b.d, rg.wait(), wg);
      if (prev >= 0) {
        wgmma_wait<1>();
        rg.release(prev);
      }
      prev = rg.stage;
      rg.next();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < P; ++c) fence_regs(acc[c]);
    rg.release(prev);
    dh_epilogue<P>(acc, mask, b, wg);
    fence_async_smem();
    if (li >= 2) hl.wait();
    consumers_sync();
    flush_db(b.db_part, bn.db[li - 1], N);
  }
  // the first layer's only input is the embedding
  dw_phase<P>(b, false, true, nullptr, bn.dw_e[0], net.epad, wg);
  egrad_chunk<N>(rg, b.d, wg, de, first);
}

__device__ __forceinline__ void backward(
    const BwdNet& bn, FedRing& rg, HLoad& hl, const BwdBufs& b,
    const float* gsrc, const unsigned char* scratch, bool h_last_loaded,
    int wg, float* de) {
  switch (bn.net.width) {
    case 64:
      backward_net_h<1>(bn, rg, hl, b, gsrc, scratch, h_last_loaded, wg, de);
      break;
    case 128:
      backward_net_h<2>(bn, rg, hl, b, gsrc, scratch, h_last_loaded, wg, de);
      break;
    case 192:
      backward_net_h<3>(bn, rg, hl, b, gsrc, scratch, h_last_loaded, wg, de);
      break;
    default:
      backward_net_h<4>(bn, rg, hl, b, gsrc, scratch, h_last_loaded, wg, de);
      break;
  }
}

// de (this thread's 32 floats of the warpgroup's 64 x 64 dE, accumulator
// layout, in device memory) as f32 rows of DE_LD in shared memory.
__device__ __forceinline__ void store_de(const float* de, float* dst, int wg) {
  const int lane = threadIdx.x & 31;
  const int r = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  const float4* q = reinterpret_cast<const float4*>(de);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 v = q[j];
    *reinterpret_cast<float2*>(dst + r * DE_LD + 8 * j + cq) =
        make_float2(v.x, v.y);
    *reinterpret_cast<float2*>(dst + (r + 8) * DE_LD + 8 * j + cq) =
        make_float2(v.z, v.w);
  }
}

// dst[r] = [add[r] +] J^T dE[r] for this warpgroup's rows r < rows, J the
// Jacobian of embed_rows' fourier embedding of pts: column lead + 6f + d is
// w_f sin(2^f p_d), column lead + 6f + 3 + d its cosine.
__device__ void jacobian_rows(const float* pts, const float* dE, int multires,
                              bool lead3, const float* hann, const float* add,
                              float* dst, int rows, int wg) {
  const int lead = lead3 ? 3 : 0;
  for (int idx = threadIdx.x & 127; idx < 64 * 3; idx += 128) {
    const int r = wg * 64 + idx / 3;
    const int d = idx - 3 * (idx / 3);
    if (r >= rows) continue;
    const int i = r * 3 + d;
    const float* row = dE + r * DE_LD;
    float acc = add != nullptr ? add[i] : 0.0f;
    if (lead3) acc += row[d];
    for (int f = 0; f < multires; ++f) {
      const float scale = (float)(1 << f);
      const float s = pts[i] * scale;
      const float w = hann != nullptr ? scale * hann[f] : scale;
      acc += w * (row[lead + 6 * f + d] * cosf(s)
                  - row[lead + 6 * f + 3 + d] * sinf(s));
    }
    dst[i] = acc;
  }
}

// Warp 0: takes tiles from the counter until a live one (written into
// `slot` with its x and g) or none is left (slot.tile = -1); dead tiles get
// dx = 0 on the way. Returns the tile, or -1.
__device__ int fetch_tile(const BwdParams& p, TileSlot& slot) {
  const int lane = threadIdx.x & 31;
  const long long n_tiles = (p.n + TILE - 1) / TILE;
  for (;;) {
    int t = 0;
    if (lane == 0) t = atomicAdd(p.next_tile, 1);
    t = __shfl_sync(0xffffffffu, t, 0);
    if (t >= n_tiles) {
      if (lane == 0) slot.tile = -1;
      return -1;
    }
    const long long r = p.n - (long long)t * TILE;
    const int rows = r < TILE ? (int)r : TILE;
    if (p.live[t] == 0) {
      for (int i = lane; i < rows * 3; i += 32)
        p.dx[(long long)t * TILE * 3 + i] = 0.0f;
      continue;
    }
    if (lane == 0) {
      slot.tile = t;
      slot.rows = rows;
    }
    for (int i = lane; i < TILE * 3; i += 32)
      slot.x[i] = i < rows * 3 ? p.x[(long long)t * TILE * 3 + i] : 0.0f;
    for (int i = lane; i < TILE * 4; i += 32)
      slot.g[i] = i < rows * 4 ? p.g[(long long)t * TILE * 4 + i] : 0.0f;
    return t;
  }
}

// Two consumer warpgroups and no producer warp (see the header).
__global__ void __launch_bounds__(CONSUMERS, 1)
fused_mlp_bwd_bf16_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ __align__(1024) unsigned char smem_bf16[];
  const Layout L = Layout::make(smem_bf16);
  // the forward runs in the h buffer
  const Bufs fb{L.sbase, L.sbase + K2_EMB_OFF, L.base, L.base + K2_EMB_OFF};
  const BwdBufs b{L.sbase, L.sbase + K2_D_OFF, L.sbase + K2_EMB_OFF,
                  L.base, L.base + K2_D_OFF, L.base + K2_EMB_OFF,
                  reinterpret_cast<float*>(L.base + K2_DB_OFF)};
  TileSlot* slots = reinterpret_cast<TileSlot*>(L.base + K2_SLOTS_OFF);
  float* xyz = reinterpret_cast<float*>(L.base + K2_XYZ_OFF);
  float* dxyz = reinterpret_cast<float*>(L.base + K2_DXYZ_OFF);
  Chunk* sched = reinterpret_cast<Chunk*>(L.base + K2_SCHED_OFF);
  const uint32_t w_full = L.sbase + K2_BAR_OFF;
  const uint32_t w_empty = w_full + 8 * K2_STAGES;
  const uint32_t h_bar = w_empty + 8 * K2_STAGES;
  const uint32_t stages = L.sbase + K2_STAGE_OFF;
  // broadcast from lane 0: the compiler then knows the warpgroup index
  // is uniform and keeps the wgmma descriptors in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x & 127;
  for (int i = threadIdx.x; i < 2 * MAX_WIDTH; i += CONSUMERS)
    b.db_part[i] = 0.0f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < K2_STAGES; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, CONSUMERS / 32);
    }
    mbar_init(h_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the chunks of one tile, in the order the code below consumes them
  // (every thread counts them, thread 0 writes them down)
  Recorder rec{threadIdx.x == 0 ? sched : nullptr, 0};
  if (!p.skip_nr) stream_forward(p.nr.net, rec);
  stream_forward(p.cnl.net, rec);
  stream_backward(p.cnl.net, rec);
  if (!p.skip_nr) stream_backward(p.nr.net, rec);
  if (threadIdx.x < 32) fetch_tile(p, slots[0]);
  __syncthreads();

  FedRing rg;
  static_cast<Ring&>(rg) = Ring{w_full, w_empty, stages, K2_STAGES, 0, 0};
  rg.sched = sched;
  rg.len = rec.n;
  rg.released = 0;
  rg.avail = slots[0].tile >= 0 ? rec.n : 0;
  rg.wg = wg;
  if (wg == 0)
    for (int k = 0; k < K2_STAGES && k < rg.avail; ++k) rg.issue(k, k);
  HLoad hl{h_bar, b.h, 0};
  unsigned char* scr_cnl = static_cast<unsigned char*>(p.scratch)
                         + (size_t)blockIdx.x * p.scratch_elems * 2;
  unsigned char* scr_nr =
      scr_cnl + (size_t)p.cnl.net.depth * TILE * p.cnl.net.width * 2;
  float* de = reinterpret_cast<float*>(
      scr_nr + (p.skip_nr ? 0 : (size_t)p.nr.net.depth * TILE
                                    * p.nr.net.width * 2)) + threadIdx.x * 32;
  // a net's dE rows go to the h buffer once its backward is done with it
  float* de_rows = reinterpret_cast<float*>(b.h_p);
  for (int j = 0;; ++j) {
    const TileSlot* s = &slots[j & 1];
    if (s->tile < 0) break;
    // the next live tile, one ahead, so that its first chunks can be
    // loaded while this one ends (everyone reads it after the first sync)
    if (threadIdx.x < 32) fetch_tile(p, slots[(j + 1) & 1]);
    const float* xs = s->x;
    float* dx = p.dx + (long long)s->tile * TILE * 3;
    float res[4];
    int row;
    // ---- forward, every layer's output kept in the block's scratch
    if (!p.skip_nr) {
      embed_rows(xs, p.nr.net.multires, false, p.hann, fb.emb_p, wg);
      fence_async_smem();
      wg_sync(wg);
      run_net(p.nr.net, rg, fb, scr_nr, wg);
      out_rows(fb.act_p, p.nr.net.width, 3,
               static_cast<const bf16*>(p.nr.net.w_out), wg, res, row);
      if ((tid & 1) == 0)
        for (int o = 0; o < 3; ++o)
          xyz[row * 3 + o] = xs[row * 3 + o] + (res[o] + p.nr.net.b_out[o]);
    } else {
      for (int i = tid; i < 64 * 3; i += 128)
        xyz[wg * 192 + i] = xs[wg * 192 + i];
    }
    wg_sync(wg);
    embed_rows(xyz, p.cnl.net.multires, true, nullptr, fb.emb_p, wg);
    fence_async_smem();
    wg_sync(wg);
    run_net(p.cnl.net, rg, fb, scr_cnl, wg);
    if (tid == 0) bulk_wait();     // the scratch is written before it is read
    consumers_sync();
    if (slots[(j + 1) & 1].tile >= 0) rg.avail = (j + 2) * rg.len;

    // ---- backward: the canonical net, then the non-rigid one; xyz = x +
    // offset, so dxyz is the cotangent of the non-rigid output and of x
    // through the identity path
    const int n_nets = p.skip_nr ? 1 : 2;
    for (int k = 0; k < n_nets; ++k) {
      const bool cnl = k == 0;
      if (!cnl) {
        consumers_sync();   // both warpgroups are done with the buffers
        embed_rows(xs, p.nr.net.multires, false, p.hann, fb.emb_p, wg);
        fence_async_smem();
        wg_sync(wg);
      }
      const BwdNet& bn = cnl ? p.cnl : p.nr;
      backward(bn, rg, hl, b, cnl ? s->g : dxyz, cnl ? scr_cnl : scr_nr,
               cnl, wg, de);
      store_de(de, de_rows, wg);
      wg_sync(wg);
      // the embedding's Jacobian: into dxyz, or (last net) into dx
      const bool last = k == n_nets - 1;
      jacobian_rows(cnl ? xyz : xs, de_rows, bn.net.multires, cnl,
                    cnl ? nullptr : p.hann, cnl ? nullptr : dxyz,
                    last ? dx : dxyz, last ? s->rows : TILE, wg);
    }
    consumers_sync();     // the buffers and the next slot, for everyone
  }
}

// ---------------------------------------------------------------------------
// f32: 64 samples a block, fmaf
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// One net, backwards. gsrc (TM, n_out) f32 in shared memory is the cotangent
// of the net's output; emb holds the net's input embedding; scratch holds
// the net's activations. On return dE (TM, epad) holds the gradient with
// respect to the embedding. buf_a / buf_b are free to use.
// ---------------------------------------------------------------------------
template <typename T>
__device__ void backward_net(const BwdNet& bn, const T* emb, T* buf_a,
                             T* buf_b, float* dE, float* stage,
                             const T* scratch, const float* gsrc) {
  constexpr int THREADS = Cfg<T>::THREADS;
  constexpr int H_LD = Cfg<T>::H_LD;
  constexpr int E_LD = Cfg<T>::E_LD;
  const NetDesc& net = bn.net;
  const int width = net.width;
  const int n_out = net.n_out;
  T* H = buf_a;     // h of the layer below the one being differentiated
  T* D = buf_b;     // dy of the layer being differentiated

  copy_rows<T>(scratch + (size_t)(net.depth - 1) * TM * width, width, H, H_LD,
               width);
  for (int idx = threadIdx.x; idx < TM * DE_LD; idx += THREADS) dE[idx] = 0.0f;
  __syncthreads();

  // output layer: dW_out = h^T g, db_out = sum g, dy = (g W_out^T) * (h > 0)
  const T* w_out = static_cast<const T*>(net.w_out);
  for (int idx = threadIdx.x; idx < width * n_out; idx += THREADS) {
    const int k = idx / n_out;
    const int o = idx - k * n_out;
    float acc = 0.0f;
    for (int s = 0; s < TM; ++s)
      acc = fmaf(to_f32(H[s * H_LD + k]), rnd<T>(gsrc[s * n_out + o]), acc);
    atomicAdd(bn.dw_out + idx, acc);
  }
  if (threadIdx.x < n_out) {
    float acc = 0.0f;
    for (int s = 0; s < TM; ++s) acc += gsrc[s * n_out + threadIdx.x];
    atomicAdd(bn.db_out + threadIdx.x, acc);
  }
  for (int idx = threadIdx.x; idx < TM * width; idx += THREADS) {
    const int s = idx / width;
    const int k = idx - s * width;
    float acc = 0.0f;
    for (int o = 0; o < n_out; ++o)
      acc = fmaf(rnd<T>(gsrc[s * n_out + o]), to_f32(w_out[k * n_out + o]),
                 acc);
    D[s * H_LD + k] =
        from_f32<T>(to_f32(H[s * H_LD + k]) > 0.0f ? acc : 0.0f);
  }
  __syncthreads();

  for (int li = net.depth - 1; li >= 1; --li) {
    copy_rows<T>(scratch + (size_t)(li - 1) * TM * width, width, H, H_LD,
                 width);
    __syncthreads();
    wgrad(H, H_LD, width, D, width, bn.dw_h[li], stage);
    bgrad<T>(D, width, bn.db[li]);
    if (net.w_e[li] != nullptr) {
      wgrad(emb, E_LD, net.epad, D, width, bn.dw_e[li], stage);
      egrad(D, width, bn.w_e_t[li], net.epad, dE);
    }
    __syncthreads();
    dgrad(D, width, bn.w_h_t[li], H, stage);
    __syncthreads();
    T* t = H; H = D; D = t;
  }
  // first layer: its only input is the embedding
  wgrad(emb, E_LD, net.epad, D, width, bn.dw_e[0], stage);
  bgrad<T>(D, width, bn.db[0]);
  egrad(D, width, bn.w_e_t[0], net.epad, dE);
  __syncthreads();
}

// dpts (TM, 3) = [dpts +] J^T dE for the fourier embedding of pts: column
// lead + 6f + d is w_f sin(2^f p_d), column lead + 6f + 3 + d its cosine.
__device__ void embed_jacobian(const float* pts, const float* dE,
                               int multires, bool lead3, const float* hann,
                               const float* add, float* dpts, int threads) {
  const int lead = lead3 ? 3 : 0;
  for (int idx = threadIdx.x; idx < TM * 3; idx += threads) {
    const int r = idx / 3;
    const int d = idx - 3 * r;
    const float* row = dE + r * DE_LD;
    float acc = add != nullptr ? add[idx] : 0.0f;
    if (lead3) acc += row[d];
    for (int f = 0; f < multires; ++f) {
      const float scale = (float)(1 << f);
      const float s = pts[idx] * scale;
      const float w = hann != nullptr ? scale * hann[f] : scale;
      acc += w * (row[lead + 6 * f + d] * cosf(s)
                  - row[lead + 6 * f + 3 + d] * sinf(s));
    }
    dpts[idx] = acc;
  }
}

template <typename T>
__global__ void
__launch_bounds__(Cfg<T>::THREADS, Cfg<T>::BLOCKS_PER_SM)
fused_mlp_bwd_kernel(const __grid_constant__ BwdParams p) {
  constexpr int THREADS = Cfg<T>::THREADS;
  constexpr int H_LD = Cfg<T>::H_LD;
  constexpr int E_LD = Cfg<T>::E_LD;
  extern __shared__ __align__(128) unsigned char smem_raw[];

  T* buf_a = reinterpret_cast<T*>(smem_raw);
  T* buf_b = buf_a + TM * H_LD;
  T* emb = buf_b + TM * H_LD;
  float* stage = reinterpret_cast<float*>(emb + TM * E_LD);
  float* dE = stage + Cfg<T>::STAGE_FLOATS;
  float* xs = dE + TM * DE_LD;
  float* xyz = xs + TM * 3;
  float* gs = xyz + TM * 3;        // (TM, 4)
  float* dxyz = gs + TM * 4;       // (TM, 3)

  T* scratch = static_cast<T*>(p.scratch) + (size_t)blockIdx.x * p.scratch_elems;
  T* scratch_cnl = scratch;
  T* scratch_nr = scratch + (size_t)p.cnl.net.depth * TM * p.cnl.net.width;

  const long long n_blocks = (p.n + TM - 1) / TM;
  for (long long blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
    const long long base = blk * TM;
    long long rows = p.n - base;
    if (rows > TM) rows = TM;
    if (p.live[base / TILE] == 0) {
      for (int idx = threadIdx.x; idx < rows * 3; idx += THREADS)
        p.dx[base * 3 + idx] = 0.0f;
      continue;
    }
    // ragged last block: rows past n read x = 0 and g = 0, add nothing to
    // any dW and are never written
    for (int idx = threadIdx.x; idx < TM * 3; idx += THREADS) {
      const float v = (idx < rows * 3) ? p.x[base * 3 + idx] : 0.0f;
      xs[idx] = v;
      xyz[idx] = v;
    }
    for (int idx = threadIdx.x; idx < TM * 4; idx += THREADS)
      gs[idx] = (idx < rows * 4) ? p.g[base * 4 + idx] : 0.0f;
    __syncthreads();

    // ---- forward, keeping the activations
    if (!p.skip_nr) {
      embed<T>(xs, p.nr.net.multires, p.nr.net.epad, false, p.hann, emb);
      __syncthreads();
      const T* h = forward_store<T>(p.nr.net, emb, buf_a, buf_b, stage,
                                    scratch_nr);
      const T* w_out = static_cast<const T*>(p.nr.net.w_out);
      for (int idx = threadIdx.x; idx < TM * 3; idx += THREADS) {
        const int r = idx / 3;
        const int o = idx - 3 * r;
        xyz[idx] = xs[idx] + out_dot<T>(h + r * H_LD, w_out, p.nr.net.width,
                                        3, o, p.nr.net.b_out[o]);
      }
      __syncthreads();
    }
    embed<T>(xyz, p.cnl.net.multires, p.cnl.net.epad, true, nullptr, emb);
    __syncthreads();
    forward_store<T>(p.cnl.net, emb, buf_a, buf_b, stage, scratch_cnl);
    __syncthreads();

    // ---- backward: canonical net, then its embedding's Jacobian
    backward_net<T>(p.cnl, emb, buf_a, buf_b, dE, stage, scratch_cnl, gs);
    embed_jacobian(xyz, dE, p.cnl.net.multires, true, nullptr, nullptr, dxyz,
                   THREADS);
    __syncthreads();

    const float* dx_src = dxyz;
    if (!p.skip_nr) {
      // xyz = x + offset: dxyz is the cotangent of the non-rigid output and
      // of x through the identity path
      embed<T>(xs, p.nr.net.multires, p.nr.net.epad, false, p.hann, emb);
      __syncthreads();
      backward_net<T>(p.nr, emb, buf_a, buf_b, dE, stage, scratch_nr, dxyz);
      embed_jacobian(xs, dE, p.nr.net.multires, false, p.hann, dxyz, gs,
                     THREADS);
      __syncthreads();
      dx_src = gs;
    }
    for (int idx = threadIdx.x; idx < rows * 3; idx += THREADS)
      p.dx[base * 3 + idx] = dx_src[idx];
    __syncthreads();
  }
}

// ptrs: the forward table [w_h, w_e, b] x MAX_DEPTH, w_out, b_out, then
// [w_h_t, w_e_t, dw_h, dw_e, db] x MAX_DEPTH, dw_out, db_out.
void fill_bwd_net(BwdNet& d, const int* desc, const void* const* ptrs) {
  fill_net(d.net, desc, ptrs);
  const void* const* q = ptrs + 3 * MAX_DEPTH + 2;
  for (int i = 0; i < MAX_DEPTH; ++i) {
    d.w_h_t[i] = q[i];
    d.w_e_t[i] = q[MAX_DEPTH + i];
    d.dw_h[i] = static_cast<float*>(const_cast<void*>(q[2 * MAX_DEPTH + i]));
    d.dw_e[i] = static_cast<float*>(const_cast<void*>(q[3 * MAX_DEPTH + i]));
    d.db[i] = static_cast<float*>(const_cast<void*>(q[4 * MAX_DEPTH + i]));
  }
  d.dw_out = static_cast<float*>(const_cast<void*>(q[5 * MAX_DEPTH]));
  d.db_out = static_cast<float*>(const_cast<void*>(q[5 * MAX_DEPTH + 1]));
}

// Opt in to the block's dynamic shared memory and ask for the largest
// shared-memory carveout.
template <class K>
cudaError_t prepare(K kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Blocks of the persistent grid: every slot the card can hold at once.
template <class K>
int resident_blocks(K kernel, int threads, size_t smem) {
  int per_sm = 0, dev = 0, sms = 0;
  if (prepare(kernel, smem) != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess)
    return -1;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return -1;
  return per_sm * sms;
}

}  // namespace

extern "C" {

// Blocks the backward kernel's persistent grid should have on the current
// device (-1 on error); the caller sizes the scratch area with it.
int fused_mlp_bwd_grid(int is_bf16) {
  return is_bf16 ? resident_blocks(fused_mlp_bwd_bf16_kernel, CONSUMERS,
                                   K2_SMEM)
                 : resident_blocks(fused_mlp_bwd_kernel<float>,
                                   Cfg<float>::THREADS,
                                   bwd_smem_bytes<float>());
}

// Dynamic shared memory a block of the backward kernel asks for, in bytes.
int fused_mlp_bwd_smem_bytes(int is_bf16) {
  return is_bf16 ? (int)K2_SMEM : (int)bwd_smem_bytes<float>();
}

// Samples a block works on at a time.
int fused_mlp_bwd_block_rows(int is_bf16) { return is_bf16 ? TILE : TM; }

// Elements of the compute type a block's scratch needs: every layer's
// activations of a block's samples and, in bf16, the f32 dE sums of its
// threads.
long long fused_mlp_bwd_scratch_elems(int is_bf16, int skip_nr,
                                      const int* nr_desc,
                                      const int* cnl_desc) {
  const long long rows = is_bf16 ? TILE : TM;
  long long need = (long long)cnl_desc[0] * rows * cnl_desc[1];
  if (!skip_nr) need += (long long)nr_desc[0] * rows * nr_desc[1];
  if (is_bf16) need += CONSUMERS * 32 * 2;
  return need;
}

// dx and the dW / db buffers named in the tables; the latter are added to and
// must come in zeroed. next_tile: one zeroed int on the device (bf16 only).
// Returns a cudaError_t (0 on success), -1 for a plan the kernel does not
// take.
int fused_mlp_backward(const float* x, const float* g, float* dx, long long n,
                       const int* live, const float* hann, int is_bf16,
                       int skip_nr, const int* nr_desc,
                       const void* const* nr_ptrs, const int* cnl_desc,
                       const void* const* cnl_ptrs, void* scratch,
                       long long scratch_elems, int grid, int* next_tile,
                       void* stream) {
  if (n <= 0) return 0;
  if (grid <= 0) return -1;
  BwdParams p;
  p.x = x;
  p.g = g;
  p.dx = dx;
  p.n = n;
  p.live = live;
  p.next_tile = next_tile;
  for (int i = 0; i < MAX_FREQ; ++i) p.hann[i] = hann[i];
  p.skip_nr = skip_nr;
  p.scratch = scratch;
  p.scratch_elems = scratch_elems;
  const int rows = is_bf16 ? TILE : TM;
  fill_bwd_net(p.cnl, cnl_desc, cnl_ptrs);
  if (!net_ok(p.cnl.net, 4)) return -1;
  if (skip_nr) {
    p.nr = p.cnl;
  } else {
    fill_bwd_net(p.nr, nr_desc, nr_ptrs);
    if (!net_ok(p.nr.net, 3)) return -1;
  }
  if (scratch_elems <
      fused_mlp_bwd_scratch_elems(is_bf16, skip_nr, nr_desc, cnl_desc))
    return -1;
  const long long blocks = (n + rows - 1) / rows;
  if (blocks > 2147483647LL - 65536) return -1;
  if (grid > blocks) grid = (int)blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    if (next_tile == nullptr) return -1;
    err = prepare(fused_mlp_bwd_bf16_kernel, K2_SMEM);
    if (err != cudaSuccess) return (int)err;
    fused_mlp_bwd_bf16_kernel<<<grid, CONSUMERS, K2_SMEM, s>>>(p);
  } else {
    err = prepare(fused_mlp_bwd_kernel<float>, bwd_smem_bytes<float>());
    if (err != cudaSuccess) return (int)err;
    fused_mlp_bwd_kernel<float><<<grid, Cfg<float>::THREADS,
                                  bwd_smem_bytes<float>(), s>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
