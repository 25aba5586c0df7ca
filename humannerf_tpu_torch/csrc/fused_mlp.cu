// Fused non-rigid + canonical MLP point query, forward only, for sm_90a.
//
// Replaces the Pallas TPU kernel humannerf_tpu/ops/pallas_mlp.py
// (`_fwd_call` -> `_fwd_kernel` / `_forward_pass`). Per 128-sample tile it
// computes, without touching device memory in between,
//
//   hann-windowed fourier embed(x) -> non-rigid MLP -> xyz = x + offset
//     -> fourier embed(xyz) -> canonical MLP -> raw (rgb, sigma)
//
// and a tile whose liveness flag is 0 writes zeros and does nothing else.
//
// What bounds it: a live sample costs about 1.17 MFLOP (default widths) and
// moves 28 bytes (12 in, 16 out), far above the card's ~295 FLOP/byte
// ridge, so the kernel is bound by tensor-core operations. The weights
// (about 1 MB in bf16) are read once a tile from L2: 1.15 MB for 150 MFLOP
// of a 128-sample tile, some 130 operations an L2 byte.
//
// What the bf16 design does about it (the Hopper layer primitive of
// fused_mlp_common.cuh): a persistent grid, one block an SM, takes tiles
// from an atomic counter; its producer warp reads the tile's points and
// streams every layer's weight k-chunks (64 input rows x the width,
// pre-tiled and pre-swizzled by the wrapper) with cp.async.bulk into a ring
// of four 32 KB stages, running ahead into the next tile while the
// consumers finish this one; dead tiles are zeroed by the producer and
// never reach the consumers. Two consumer warpgroups, 64 rows each, run
// every hidden layer as wgmma.mma_async m64nNk16 (N = width) with both
// operands in shared memory and the sum in registers, and write bias + relu
// + bf16 rounding from the registers straight into the next layer's
// swizzled operand, in place; a warpgroup only ever synchronises with
// itself (named barriers over 128 threads). The narrow output layers and
// the embeddings stay on CUDA cores. f32 mode keeps the fmaf kernel: 64
// samples a block, one block a tile half.
//
// ptxas -v (sm_90a, CUDA 12.8), bf16 kernel: 168 registers, no spill, 32 B
// of stack; 222 848 B of dynamic shared memory a block (64 KB activations,
// 16 KB embedding, 4 x 32 KB weight stages, tile slots, barriers).
//
// Numerics (the JAX kernel's operand semantics):
//   bf16 mode: both operands of every product are rounded to bf16, sums
//     accumulate in f32, bias add and relu in f32, an activation is rounded
//     to bf16 only as the next product's operand. Embeddings are computed in
//     f32 from f32 x / xyz; xyz = x + offset in f32.
//   f32 mode: everything in f32 with fmaf (no TF32).
// The condition code is folded into the first non-rigid bias by the caller.
//
// Layout: x (N, 3) f32 row-major in, raw (N, 4) f32 row-major out. Embedding
// columns follow the reference order ([w_i sin(2^i x), w_i cos(2^i x)] per
// frequency; the canonical embed leads with xyz) and are zero-padded to a
// multiple of 16; the caller pads the matching weight rows with zeros.

#include "fused_mlp_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: the Hopper kernel
// ---------------------------------------------------------------------------

constexpr int K1_STAGES = 4;
constexpr int K1_SLOTS_OFF =
    ACT_BYTES + EMB_BYTES + K1_STAGES * CHUNK_MAX_BYTES;
constexpr int K1_XYZ_OFF = K1_SLOTS_OFF + 2 * (int)sizeof(TileSlot);
constexpr int K1_BAR_OFF = K1_XYZ_OFF + TILE * 3 * 4;
constexpr size_t K1_SMEM = 1024 + K1_BAR_OFF + (2 * K1_STAGES + 4) * 8;

__global__ void __launch_bounds__(THREADS_H, 1)
fused_mlp_bf16_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem_bf16[];
  const Layout L = Layout::make(smem_bf16);
  const Bufs b{L.sbase, L.sbase + ACT_BYTES, L.base, L.base + ACT_BYTES};
  TileSlot* slots = reinterpret_cast<TileSlot*>(L.base + K1_SLOTS_OFF);
  float* xyz = reinterpret_cast<float*>(L.base + K1_XYZ_OFF);
  const uint32_t w_full = L.sbase + K1_BAR_OFF;
  const uint32_t w_empty = w_full + 8 * K1_STAGES;
  const uint32_t t_full = w_empty + 8 * K1_STAGES;
  const uint32_t t_empty = t_full + 16;
  const uint32_t stages = L.sbase + ACT_BYTES + EMB_BYTES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < K1_STAGES; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, CONSUMERS / 32);
    }
    for (int k = 0; k < 2; ++k) {
      mbar_init(t_full + 8 * k, 32);
      mbar_init(t_empty + 8 * k, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // broadcast from lane 0: the compiler then knows the warpgroup index
  // is uniform and keeps the wgmma descriptors in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {                   // the producer warp
    Feed feed{w_full, w_empty, stages, K1_STAGES, 0, 0};
    const int lane = threadIdx.x & 31;
    produce(
        p.n, p.live, p.next_tile, slots, t_full, t_empty,
        [&](int t, int rows) {
          for (int i = lane; i < rows * 4; i += 32)
            p.out[(long long)t * TILE * 4 + i] = 0.0f;
        },
        [&](TileSlot& s, int t, int rows) {
          for (int i = lane; i < TILE * 3; i += 32)
            s.x[i] = i < rows * 3 ? p.x[(long long)t * TILE * 3 + i] : 0.0f;
        },
        [&]() {
          if (!p.skip_nr) stream_forward(p.nr, feed);
          stream_forward(p.cnl, feed);
        });
  } else {
    Ring rg{w_full, w_empty, stages, K1_STAGES, 0, 0};
    TileFeed tf{slots, t_full, t_empty, 0, 0};
    const int tid = threadIdx.x & 127;
    while (const TileSlot* s = tf.next()) {
      const float* xs = s->x;
      float res[4];
      int row;
      if (!p.skip_nr) {
        embed_rows(xs, p.nr.multires, false, p.hann, b.emb_p, wg);
        fence_async_smem();
        wg_sync(wg);
        run_net(p.nr, rg, b, nullptr, wg);
        out_rows(b.act_p, p.nr.width, 3, static_cast<const bf16*>(p.nr.w_out),
                 wg, res, row);
        if ((tid & 1) == 0)
          for (int o = 0; o < 3; ++o)
            xyz[row * 3 + o] = xs[row * 3 + o] + (res[o] + p.nr.b_out[o]);
      } else {
        for (int i = tid; i < 64 * 3; i += 128)
          xyz[wg * 192 + i] = xs[wg * 192 + i];
      }
      wg_sync(wg);
      embed_rows(xyz, p.cnl.multires, true, nullptr, b.emb_p, wg);
      fence_async_smem();
      wg_sync(wg);
      run_net(p.cnl, rg, b, nullptr, wg);
      out_rows(b.act_p, p.cnl.width, 4, static_cast<const bf16*>(p.cnl.w_out),
               wg, res, row);
      if ((tid & 1) == 0 && row < s->rows)
        *reinterpret_cast<float4*>(
            p.out + ((long long)s->tile * TILE + row) * 4) =
            make_float4(res[0] + p.cnl.b_out[0], res[1] + p.cnl.b_out[1],
                        res[2] + p.cnl.b_out[2], res[3] + p.cnl.b_out[3]);
      tf.release();
    }
  }
}

// ---------------------------------------------------------------------------
// f32: 64 samples a block, fmaf
// ---------------------------------------------------------------------------

template <typename T>
__global__ void
__launch_bounds__(Cfg<T>::THREADS, Cfg<T>::BLOCKS_PER_SM)
fused_mlp_kernel(const __grid_constant__ Params p) {
  constexpr int THREADS = Cfg<T>::THREADS;
  constexpr int H_LD = Cfg<T>::H_LD;
  constexpr int E_LD = Cfg<T>::E_LD;
  extern __shared__ __align__(128) unsigned char smem_raw[];

  const long long base = (long long)blockIdx.x * TM;
  if (p.live[base / TILE] == 0) {
    // dead tile: the output buffer is uninitialised, so write the zeros here
    long long rows = p.n - base;
    if (rows > TM) rows = TM;
    for (int idx = threadIdx.x; idx < rows * 4; idx += THREADS)
      p.out[base * 4 + idx] = 0.0f;
    return;
  }

  T* buf_a = reinterpret_cast<T*>(smem_raw);
  T* buf_b = buf_a + TM * H_LD;
  T* emb = buf_b + TM * H_LD;
  float* stage = reinterpret_cast<float*>(emb + TM * E_LD);
  float* xs = stage + Cfg<T>::STAGE_FLOATS;
  float* xyz = xs + TM * 3;

  // ragged last block: rows past n read as 0 and are never written
  for (int idx = threadIdx.x; idx < TM * 3; idx += THREADS) {
    const long long g = base * 3 + idx;
    const float v = (g < p.n * 3) ? p.x[g] : 0.0f;
    xs[idx] = v;
    xyz[idx] = v;
  }
  __syncthreads();

  if (!p.skip_nr) {
    embed<T>(xs, p.nr.multires, p.nr.epad, false, p.hann, emb);
    __syncthreads();
    const T* h = hidden_layers<T>(p.nr, emb, buf_a, buf_b, stage);
    const T* w_out = static_cast<const T*>(p.nr.w_out);
    for (int idx = threadIdx.x; idx < TM * 3; idx += THREADS) {
      const int r = idx / 3;
      const int o = idx - 3 * r;
      xyz[idx] = xs[idx] + out_dot<T>(h + r * H_LD, w_out, p.nr.width, 3, o,
                                      p.nr.b_out[o]);
    }
    __syncthreads();
  }

  embed<T>(xyz, p.cnl.multires, p.cnl.epad, true, nullptr, emb);
  __syncthreads();
  const T* h = hidden_layers<T>(p.cnl, emb, buf_a, buf_b, stage);
  const T* w_out = static_cast<const T*>(p.cnl.w_out);
  for (int idx = threadIdx.x; idx < TM * 4; idx += THREADS) {
    const int r = idx >> 2;
    const int o = idx & 3;
    if (base + r < p.n)
      p.out[base * 4 + idx] = out_dot<T>(h + r * H_LD, w_out, p.cnl.width, 4,
                                         o, p.cnl.b_out[o]);
  }
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

template <class K>
int blocks_per_sm(K kernel, int threads, size_t smem) {
  int n = 0;
  if (prepare(kernel, smem) != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return -1;
  return sms;
}

}  // namespace

extern "C" {

// Blocks of the kernel that can be resident on one SM (-1 on error).
int fused_mlp_blocks_per_sm(int is_bf16) {
  return is_bf16
      ? blocks_per_sm(fused_mlp_bf16_kernel, THREADS_H, K1_SMEM)
      : blocks_per_sm(fused_mlp_kernel<float>, Cfg<float>::THREADS,
                      smem_bytes<float>());
}

// Dynamic shared memory a block of the kernel asks for, in bytes.
int fused_mlp_smem_bytes(int is_bf16) {
  return is_bf16 ? (int)K1_SMEM : (int)smem_bytes<float>();
}

// Constants the Python wrapper must agree with.
int fused_mlp_tile() { return TILE; }
int fused_mlp_max_depth() { return MAX_DEPTH; }

// desc: {depth, width, multires, epad, n_out}; ptrs: w_h[MAX_DEPTH],
// w_e[MAX_DEPTH], b[MAX_DEPTH], w_out, b_out (device pointers, null where a
// layer has no such operand). hann: MAX_FREQ host floats. next_tile: one
// zeroed int on the device (bf16 only: the persistent grid's tile counter).
// Returns a cudaError_t (0 on success); -1 for a plan the kernel does not
// take.
int fused_mlp_forward(const float* x, float* out, long long n,
                      const int* live, const float* hann, int is_bf16,
                      int skip_nr, const int* nr_desc,
                      const void* const* nr_ptrs, const int* cnl_desc,
                      const void* const* cnl_ptrs, int* next_tile,
                      void* stream) {
  if (n <= 0) return 0;
  Params p;
  p.x = x;
  p.out = out;
  p.n = n;
  p.live = live;
  p.next_tile = next_tile;
  for (int i = 0; i < MAX_FREQ; ++i) p.hann[i] = hann[i];
  p.skip_nr = skip_nr;
  fill_net(p.cnl, cnl_desc, cnl_ptrs);
  if (!net_ok(p.cnl, 4)) return -1;
  if (skip_nr) {
    p.nr = p.cnl;
  } else {
    fill_net(p.nr, nr_desc, nr_ptrs);
    if (!net_ok(p.nr, 3)) return -1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    if (next_tile == nullptr) return -1;
    const long long tiles = (n + TILE - 1) / TILE;
    if (tiles > 2147483647LL - 65536) return -1;
    const int sms = sm_count();
    if (sms <= 0) return -1;
    const int grid = tiles < sms ? (int)tiles : sms;
    err = prepare(fused_mlp_bf16_kernel, K1_SMEM);
    if (err != cudaSuccess) return (int)err;
    fused_mlp_bf16_kernel<<<grid, THREADS_H, K1_SMEM, s>>>(p);
  } else {
    const long long blocks = (n + TM - 1) / TM;
    if (blocks > 2147483647LL) return -1;
    err = prepare(fused_mlp_kernel<float>, smem_bytes<float>());
    if (err != cudaSuccess) return (int)err;
    fused_mlp_kernel<float><<<(unsigned)blocks, Cfg<float>::THREADS,
                              smem_bytes<float>(), s>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
