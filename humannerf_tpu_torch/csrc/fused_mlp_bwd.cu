// Backward of the fused non-rigid + canonical MLP point query, for sm_90a.
//
// Replaces the Pallas TPU kernel humannerf_tpu/ops/pallas_mlp.py
// (`_bwd_call` -> `_bwd_kernel` / `_bwd_block`). Given the cotangent g (N, 4)
// of raw it recomputes the forward of fused_mlp.cu for a block of 64 samples,
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
// What bounds it: about three times the forward's operations a live sample
// (recompute + two products a layer) against 44 bytes, so tensor-core
// operations, as the forward. What this design does about the two things the
// forward did not have:
//   * 14 layers of activations of one block (360 KB) do not fit in shared
//     memory beside the working buffers. Each resident block owns a scratch
//     area in device memory, written once and read once a block; the grid is
//     persistent (one block per resident slot, looping over the blocks of
//     samples), so the scratch is a few tens of MB that mostly stay in L2.
//   * dW has no owner block. Every block adds its 64-sample product into the
//     f32 gradient buffers with atomicAdd (in bf16 mode four neighbouring
//     floats at a time, the 16-byte vector atomic of sm_90). The order of
//     these sums, and with it the last bits of dW, varies from run to run.
//     About 0.6 M floats a live block at the default widths; measured, the
//     atomics are not what the kernel's time goes to (scalar or vector: 3 %).
//
// Numerics: bf16 mode rounds both operands of every product to bf16 (dy and
// the cotangents included) and accumulates in f32, as the forward; the relu
// mask is taken from the stored (rounded) activation. f32 mode is fmaf only.

#include "fused_mlp_common.cuh"

namespace {

constexpr int DE_LD = MAX_EPAD + 8;   // row stride of the f32 dE buffer

struct BwdNet {
  NetDesc net;                      // the forward's operands
  // (out, in) copies for dh = dy W^T; in bf16 these are net.w_h / net.w_e
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
  float hann[MAX_FREQ];
  int skip_nr;
  void* scratch;                    // per resident block: all activations
  long long scratch_elems;          // elements of T per block
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

// ---------------------------------------------------------------------------
// dW += A^T D over the block's TM samples. A (TM, rows_in) with stride lda is
// the layer's input (h_prev or the embedding), D (TM, width_out) is dy.
// ---------------------------------------------------------------------------
__device__ void wgrad(const bf16* A, int lda, int rows_in, const bf16* D,
                      int width_out, float* dW, float* stage) {
  using namespace nvcuda;
  constexpr int H_LD = Cfg<bf16>::H_LD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_ct = width_out / 16;
  const int n_tiles = (rows_in / 16) * n_ct;
  float* st = stage + warp * 256;
  for (int t = warp; t < n_tiles; t += Cfg<bf16>::THREADS / 32) {
    const int m0 = (t / n_ct) * 16;
    const int n0 = (t % n_ct) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int k0 = 0; k0 < TM; k0 += 16) {
      // A^T: element (m, k) of the fragment is A[k][m], a col_major read
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
      wmma::load_matrix_sync(af, A + k0 * lda + m0, lda);
      wmma::load_matrix_sync(bfr, D + k0 * H_LD + n0, H_LD);
      wmma::mma_sync(acc, af, bfr, acc);
    }
    wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
    __syncwarp();
    // four neighbouring columns a lane: one 16-byte vector atomic each
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = lane + 32 * q;
      const int r = e >> 2;
      const int c = (e & 3) * 4;
      atomicAdd(reinterpret_cast<float4*>(
                    dW + (size_t)(m0 + r) * width_out + n0 + c),
                *reinterpret_cast<const float4*>(st + r * 16 + c));
    }
    __syncwarp();
  }
}

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

// ---------------------------------------------------------------------------
// dE += D W_e^T: the embedding's share of a layer's input gradient, kept in
// f32 in shared memory. w_t is W_e stored (out, epad).
// ---------------------------------------------------------------------------
__device__ void egrad(const bf16* D, int width, const void* w_t_, int epad,
                      float* dE) {
  using namespace nvcuda;
  constexpr int H_LD = Cfg<bf16>::H_LD;
  const bf16* w_t = static_cast<const bf16*>(w_t_);
  const int warp = threadIdx.x >> 5;
  const int n_ct = epad / 16;
  for (int t = warp; t < (TM / 16) * n_ct; t += Cfg<bf16>::THREADS / 32) {
    const int i = t / n_ct;
    const int j = t % n_ct;
    float* tile = dE + 16 * i * DE_LD + 16 * j;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, tile, DE_LD, wmma::mem_row_major);
    for (int k0 = 0; k0 < width; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
      wmma::load_matrix_sync(af, D + 16 * i * H_LD + k0, H_LD);
      wmma::load_matrix_sync(bfr, w_t + (size_t)k0 * epad + 16 * j, epad);
      wmma::mma_sync(acc, af, bfr, acc);
    }
    wmma::store_matrix_sync(tile, acc, DE_LD, wmma::mem_row_major);
  }
}

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

// ---------------------------------------------------------------------------
// H <- (D W^T) * (H > 0), in place: the next dy from this layer's dy. w_t is
// the layer's w_h stored (out, in); all widths are equal.
// ---------------------------------------------------------------------------
template <int NF>
__device__ void dgrad_wmma(const bf16* D, int width, const bf16* w_t, bf16* H,
                           float* stage) {
  using namespace nvcuda;
  constexpr int H_LD = Cfg<bf16>::H_LD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col_base = warp * (16 * NF);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][NF];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k = 0; k < width; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wmma::load_matrix_sync(af[i], D + (16 * i) * H_LD + k, H_LD);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      // element (k, n) of W^T is w_t[k][n]: a row_major read of (out, in)
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
      wmma::load_matrix_sync(bfr, w_t + (size_t)k * width + col_base + 16 * j,
                             width);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::mma_sync(acc[i][j], af[i], bfr, acc[i][j]);
    }
  }

  float* st = stage + warp * 256;
  const int pr = lane >> 3;
  const int pc = (lane & 7) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      bf16* out = H + (16 * i) * H_LD + col_base + 16 * j + pc;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = pr + 4 * q;
        const float2 v = *reinterpret_cast<const float2*>(st + row * 16 + pc);
        __nv_bfloat162* hp =
            reinterpret_cast<__nv_bfloat162*>(out + row * H_LD);
        const float2 h = __bfloat1622float2(*hp);
        *hp = __floats2bfloat162_rn(h.x > 0.0f ? v.x : 0.0f,
                                    h.y > 0.0f ? v.y : 0.0f);
      }
      __syncwarp();
    }
  }
}

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

__device__ void dgrad(const bf16* D, int width, const void* w_t, bf16* H,
                      float* stage) {
  const bf16* w = static_cast<const bf16*>(w_t);
  switch (width / 64) {
    case 1: dgrad_wmma<1>(D, width, w, H, stage); break;
    case 2: dgrad_wmma<2>(D, width, w, H, stage); break;
    case 3: dgrad_wmma<3>(D, width, w, H, stage); break;
    default: dgrad_wmma<4>(D, width, w, H, stage); break;
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

template <typename T>
cudaError_t prepare_bwd_kernel() {
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bwd_smem_bytes<T>());
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fused_mlp_bwd_kernel<T>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Blocks of the persistent grid: every slot the card can hold at once.
template <typename T>
int resident_blocks() {
  int per_sm = 0, dev = 0, sms = 0;
  if (prepare_bwd_kernel<T>() != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_mlp_bwd_kernel<T>, Cfg<T>::THREADS,
          bwd_smem_bytes<T>()) != cudaSuccess)
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
  return is_bf16 ? resident_blocks<bf16>() : resident_blocks<float>();
}

// Samples a block works on at a time: the scratch area holds
// grid * sum(depth * width) * this many elements of the compute type.
int fused_mlp_bwd_block_rows() { return TM; }

// dx and the dW / db buffers named in the tables; the latter are added to and
// must come in zeroed. Returns a cudaError_t (0 on success), -1 for a plan
// the kernel does not take.
int fused_mlp_backward(const float* x, const float* g, float* dx, long long n,
                       const int* live, const float* hann, int is_bf16,
                       int skip_nr, const int* nr_desc,
                       const void* const* nr_ptrs, const int* cnl_desc,
                       const void* const* cnl_ptrs, void* scratch,
                       long long scratch_elems, int grid, void* stream) {
  if (n <= 0) return 0;
  if (grid <= 0) return -1;
  BwdParams p;
  p.x = x;
  p.g = g;
  p.dx = dx;
  p.n = n;
  p.live = live;
  for (int i = 0; i < MAX_FREQ; ++i) p.hann[i] = hann[i];
  p.skip_nr = skip_nr;
  p.scratch = scratch;
  p.scratch_elems = scratch_elems;
  fill_bwd_net(p.cnl, cnl_desc, cnl_ptrs);
  if (!net_ok(p.cnl.net, 4)) return -1;
  long long need = (long long)p.cnl.net.depth * TM * p.cnl.net.width;
  if (skip_nr) {
    p.nr = p.cnl;
  } else {
    fill_bwd_net(p.nr, nr_desc, nr_ptrs);
    if (!net_ok(p.nr.net, 3)) return -1;
    need += (long long)p.nr.net.depth * TM * p.nr.net.width;
  }
  if (scratch_elems < need) return -1;
  const long long blocks = (n + TM - 1) / TM;
  if (grid > blocks) grid = (int)blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = prepare_bwd_kernel<bf16>();
    if (err != cudaSuccess) return (int)err;
    fused_mlp_bwd_kernel<bf16><<<grid, Cfg<bf16>::THREADS,
                                 bwd_smem_bytes<bf16>(), s>>>(p);
  } else {
    err = prepare_bwd_kernel<float>();
    if (err != cudaSuccess) return (int)err;
    fused_mlp_bwd_kernel<float><<<grid, Cfg<float>::THREADS,
                                  bwd_smem_bytes<float>(), s>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
