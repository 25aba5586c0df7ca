// Device code shared by the fused-MLP forward kernel (fused_mlp.cu) and its
// backward kernel (fused_mlp_bwd.cu): the per-type block configuration, the
// net descriptor, the hidden-layer products (bf16 on nvcuda::wmma with f32
// accumulation, f32 on fmaf), the fourier embedding and the narrow output
// layer. Everything has internal linkage; each .cu includes it once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TILE = 128;       // liveness granularity, in samples
constexpr int TM = 64;          // samples per block: half a tile
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
  // hidden-layer weights: f32 as (in, out); bf16 transposed, (out, in)
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
  float hann[MAX_FREQ]; // hann window weight per non-rigid frequency
  int skip_nr;          // 1: xyz = x, no non-rigid net
  NetDesc nr;
  NetDesc cnl;
};

// Per compute type: threads a block, blocks meant to share an SM, and
// shared-memory row strides. bf16 strides keep every wmma tile pointer
// 32-byte aligned (a multiple of 8 elements) while stepping rows by 4 banks.
template <typename T> struct Cfg;
template <> struct Cfg<bf16> {
  static constexpr int THREADS = 128;   // 4 warps, one column quarter each
  static constexpr int BLOCKS_PER_SM = 2;
  static constexpr int H_LD = MAX_WIDTH + 8;
  static constexpr int E_LD = MAX_EPAD + 8;
  static constexpr int STAGE_FLOATS = (THREADS / 32) * 256;
};
template <> struct Cfg<float> {
  static constexpr int THREADS = 256;   // 8 warps x 8 rows
  static constexpr int BLOCKS_PER_SM = 1;
  static constexpr int H_LD = MAX_WIDTH + 4;
  static constexpr int E_LD = MAX_EPAD + 4;
  static constexpr int STAGE_FLOATS = 0;
};

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * (2 * TM * Cfg<T>::H_LD + TM * Cfg<T>::E_LD)
       + sizeof(float) * (Cfg<T>::STAGE_FLOATS + 2 * TM * 3);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);   // round to nearest even
}

// ---------------------------------------------------------------------------
// Hidden layer, bf16: dst = relu([a_h | a_e] @ [w_h ; w_e] + bias)
// 4 warps, one column quarter each over all 64 rows: a warp owns 4 x NF
// accumulator fragments, NF = width / 64.
// ---------------------------------------------------------------------------
template <int NF>
__device__ void dense_wmma(const bf16* a_h, int k_h, const bf16* w_h,
                           const bf16* a_e, int k_e, const bf16* w_e,
                           const float* __restrict__ bias, int width,
                           bf16* dst, float* stage) {
  using namespace nvcuda;
  constexpr int H_LD = Cfg<bf16>::H_LD;
  constexpr int E_LD = Cfg<bf16>::E_LD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col_base = warp * (16 * NF);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][NF];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  auto run = [&](const bf16* a, int lda, int K, const bf16* w) {
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], a + (16 * i) * lda + k, lda);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        // weights are stored (out, in): a col_major fragment then finds its
        // pairs along k next to each other and loads them as 4-byte words
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
        wmma::load_matrix_sync(bfr, w + (size_t)(col_base + 16 * j) * K + k,
                               K);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
      }
    }
  };
  if (w_h != nullptr) run(a_h, H_LD, k_h, w_h);
  if (w_e != nullptr) run(a_e, E_LD, k_e, w_e);

  // Epilogue through a per-warp 16x16 f32 staging tile (the accumulator
  // fragment's layout is opaque): bias, relu, rounding to bf16. A lane takes
  // one column pair in rows pr, pr + 4, pr + 8, pr + 12: 8 lanes read one
  // 64-byte row as float2, so a half-warp's read has no bank conflict.
  float* st = stage + warp * 256;
  const int pr = lane >> 3;
  const int pc = (lane & 7) * 2;
  float2 bia[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j)
    bia[j] = *reinterpret_cast<const float2*>(bias + col_base + 16 * j + pc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      bf16* out = dst + (16 * i) * H_LD + col_base + 16 * j + pc;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = pr + 4 * q;
        const float2 v = *reinterpret_cast<const float2*>(st + row * 16 + pc);
        *reinterpret_cast<__nv_bfloat162*>(out + row * H_LD) =
            __floats2bfloat162_rn(fmaxf(v.x + bia[j].x, 0.0f),
                                  fmaxf(v.y + bia[j].y, 0.0f));
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// Hidden layer, f32: plain fmaf loops. 8 warps x 8 rows; a lane owns CPT =
// width / 32 neighbouring columns, so a warp reads weight rows coalesced and
// activations as shared-memory broadcasts.
// ---------------------------------------------------------------------------
template <int CPT>
__device__ void dense_fma(const float* a_h, int k_h, const float* w_h,
                          const float* a_e, int k_e, const float* w_e,
                          const float* __restrict__ bias, int width,
                          float* dst) {
  constexpr int H_LD = Cfg<float>::H_LD;
  constexpr int E_LD = Cfg<float>::E_LD;
  const int r0 = (threadIdx.x >> 5) * 8;
  const int c0 = (threadIdx.x & 31) * CPT;
  float acc[8][CPT];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[r][j] = 0.0f;

  auto run = [&](const float* a, int lda, int K, const float* __restrict__ w) {
    for (int k = 0; k < K; ++k) {
      float wv[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) wv[j] = w[(size_t)k * width + c0 + j];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float av = a[(r0 + r) * lda + k];
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[r][j] = fmaf(av, wv[j], acc[r][j]);
      }
    }
  };
  if (w_h != nullptr) run(a_h, H_LD, k_h, w_h);
  if (w_e != nullptr) run(a_e, E_LD, k_e, w_e);

#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      dst[(r0 + r) * H_LD + c0 + j] = fmaxf(acc[r][j] + bias[c0 + j], 0.0f);
}

template <typename T>
__device__ void dense(const T* a_h, int k_h, const void* w_h,
                      const T* a_e, int k_e, const void* w_e,
                      const float* bias, int width, T* dst, float* stage);

template <>
__device__ void dense<bf16>(const bf16* a_h, int k_h, const void* w_h,
                            const bf16* a_e, int k_e, const void* w_e,
                            const float* bias, int width, bf16* dst,
                            float* stage) {
  const bf16* wh = static_cast<const bf16*>(w_h);
  const bf16* we = static_cast<const bf16*>(w_e);
  switch (width / 64) {
    case 1: dense_wmma<1>(a_h, k_h, wh, a_e, k_e, we, bias, width, dst, stage); break;
    case 2: dense_wmma<2>(a_h, k_h, wh, a_e, k_e, we, bias, width, dst, stage); break;
    case 3: dense_wmma<3>(a_h, k_h, wh, a_e, k_e, we, bias, width, dst, stage); break;
    default: dense_wmma<4>(a_h, k_h, wh, a_e, k_e, we, bias, width, dst, stage); break;
  }
}

template <>
__device__ void dense<float>(const float* a_h, int k_h, const void* w_h,
                             const float* a_e, int k_e, const void* w_e,
                             const float* bias, int width, float* dst,
                             float* /*stage*/) {
  const float* wh = static_cast<const float*>(w_h);
  const float* we = static_cast<const float*>(w_e);
  switch (width / 64) {
    case 1: dense_fma<2>(a_h, k_h, wh, a_e, k_e, we, bias, width, dst); break;
    case 2: dense_fma<4>(a_h, k_h, wh, a_e, k_e, we, bias, width, dst); break;
    case 3: dense_fma<6>(a_h, k_h, wh, a_e, k_e, we, bias, width, dst); break;
    default: dense_fma<8>(a_h, k_h, wh, a_e, k_e, we, bias, width, dst); break;
  }
}

// Fourier embedding of pts (TM, 3) into emb (TM, E_LD), columns >= used are 0.
// lead3: the canonical embed starts with the point itself; hann: per-frequency
// window weight (non-rigid embed) or null.
template <typename T>
__device__ void embed(const float* pts, int multires, int epad, bool lead3,
                      const float* hann, T* emb) {
  constexpr int E_LD = Cfg<T>::E_LD;
  const int lead = lead3 ? 3 : 0;
  for (int idx = threadIdx.x; idx < TM * epad; idx += Cfg<T>::THREADS) {
    const int r = idx / epad;
    const int c = idx - r * epad;
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
    emb[r * E_LD + c] = from_f32<T>(v);
  }
}

// Narrow output layer (3 or 4 columns) as scalar dot products:
// res = h @ w_out + b_out, operands as stored (bf16 or f32), f32 accumulate.
template <typename T>
__device__ __forceinline__ float out_dot(const T* h_row, const T* w, int K,
                                         int n_out, int o, float b) {
  float acc = 0.0f;
  for (int k = 0; k < K; ++k)
    acc = fmaf(to_f32(h_row[k]), to_f32(w[k * n_out + o]), acc);
  return acc + b;
}

// Runs one net's hidden layers; returns the buffer that holds the last h.
template <typename T>
__device__ T* hidden_layers(const NetDesc& net, const T* emb, T* buf_a,
                            T* buf_b, float* stage) {
  T* cur = buf_a;
  T* nxt = buf_b;
  dense<T>(nullptr, 0, nullptr, emb, net.epad, net.w_e[0], net.b[0],
           net.width, cur, stage);
  __syncthreads();
  for (int li = 1; li < net.depth; ++li) {
    dense<T>(cur, net.width, net.w_h[li], emb, net.epad, net.w_e[li],
             net.b[li], net.width, nxt, stage);
    __syncthreads();
    T* t = cur; cur = nxt; nxt = t;
  }
  return cur;
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
