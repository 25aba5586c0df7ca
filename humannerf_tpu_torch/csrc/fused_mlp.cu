// Fused non-rigid + canonical MLP point query, forward only, for sm_90a.
//
// Replaces the Pallas TPU kernel humannerf_tpu/ops/pallas_mlp.py
// (`_fwd_call` -> `_fwd_kernel` / `_forward_pass`). Per block of 64 samples
// (half a 128-sample liveness tile) it computes, without touching device
// memory in between,
//
//   hann-windowed fourier embed(x) -> non-rigid MLP -> xyz = x + offset
//     -> fourier embed(xyz) -> canonical MLP -> raw (rgb, sigma)
//
// and a tile whose liveness flag is 0 writes zeros and does nothing else.
//
// What bounds it: a live sample costs about 1.17 MFLOP (default widths) and
// moves 28 bytes (12 in, 16 out), far above the card's ~295 FLOP/byte
// ridge, so the kernel is bound by tensor-core operations, not by bytes.
// What this design does about it: activations never leave shared memory
// (two ping-pong buffers plus the embedding, which skip layers re-read),
// weights (about 1 MB in bf16, resident in L2) are read from global memory
// straight into matrix fragments (stored (out, in) in bf16 so that a
// fragment loads as 4-byte words), and in bf16 mode every hidden-layer
// product runs on the tensor cores (nvcuda::wmma m16n16k16, f32
// accumulate). A bf16 block is 4 warps on 64 samples, small enough for two
// blocks to share an SM (every layer ends in a __syncthreads, so one block
// alone loads, multiplies and runs its epilogue one after the other). The
// kernel reaches about an eighth of the tensor-core peak; wgmma, staging of
// the weights through shared memory and persistence are left to later work.
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
// shared-memory carveout, so that BLOCKS_PER_SM blocks fit beside each other.
template <typename T>
cudaError_t prepare_kernel() {
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<T>());
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fused_mlp_kernel<T>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T>
int blocks_per_sm() {
  int n = 0;
  if (prepare_kernel<T>() != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, fused_mlp_kernel<T>, Cfg<T>::THREADS, smem_bytes<T>()) !=
      cudaSuccess)
    return -1;
  return n;
}

}  // namespace

extern "C" {

// Blocks of the kernel that can be resident on one SM (-1 on error).
int fused_mlp_blocks_per_sm(int is_bf16) {
  return is_bf16 ? blocks_per_sm<bf16>() : blocks_per_sm<float>();
}

// Constants the Python wrapper must agree with.
int fused_mlp_tile() { return TILE; }
int fused_mlp_max_depth() { return MAX_DEPTH; }

// desc: {depth, width, multires, epad, n_out}; ptrs: w_h[MAX_DEPTH],
// w_e[MAX_DEPTH], b[MAX_DEPTH], w_out, b_out (device pointers, null where a
// layer has no such operand). hann: MAX_FREQ host floats. Returns a
// cudaError_t (0 on success); -1 for a plan the kernel does not take.
int fused_mlp_forward(const float* x, float* out, long long n,
                      const int* live, const float* hann, int is_bf16,
                      int skip_nr, const int* nr_desc,
                      const void* const* nr_ptrs, const int* cnl_desc,
                      const void* const* cnl_ptrs, void* stream) {
  if (n <= 0) return 0;
  Params p;
  p.x = x;
  p.out = out;
  p.n = n;
  p.live = live;
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
  const long long blocks = (n + TM - 1) / TM;
  if (blocks > 2147483647LL) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = prepare_kernel<bf16>();
    if (err != cudaSuccess) return (int)err;
    fused_mlp_kernel<bf16><<<(unsigned)blocks, Cfg<bf16>::THREADS,
                             smem_bytes<bf16>(), s>>>(p);
  } else {
    err = prepare_kernel<float>();
    if (err != cudaSuccess) return (int)err;
    fused_mlp_kernel<float><<<(unsigned)blocks, Cfg<float>::THREADS,
                              smem_bytes<float>(), s>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
