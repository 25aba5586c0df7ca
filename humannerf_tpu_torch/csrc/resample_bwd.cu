// Backward of the all-bone observation-grid weight resample, for sm_90a.
//
// Replaces the Pallas TPU kernels humannerf_tpu/ops/pallas_resample.py
// (`_bwd_call` -> `_bwd_kernel` and `_bwd_kernel_win`). The forward sampled
// each of K bone weight volumes (D, H, W) trilinearly (zeros outside,
// corners aligned) at the G^3 observation-grid points warped by the bone's
// affine q = A_k p + t_k. Given g (K, G^3), the cotangent of the samples,
// this kernel adds
//
//   d(vols)[k][corner] += g * (product of the corner's three lerp weights)
//   dA[k] += dq p^T,  dT[k] += dq,   dq = g * d(sample)/dq
//
// One thread per (grid point, bone); a block is 256 points of one bone. It
// recomputes the fractional coordinates and the 2-hot lerps exactly as the
// forward formed them (in bf16 mode the lerp weights and the volume values
// are rounded to bf16, and the rounding is differentiated straight through),
// adds its eight corner terms into d(vols) with atomics, and reduces dq p^T
// and dq over the block (warp shuffles, then shared memory) into one atomic
// per block and entry. A block whose cotangents are all exactly zero does
// nothing, and so does a thread: those are most of the grid, which lies in
// empty space. The bone-support skip of the TPU kernel (exact only through
// the softmax that follows) is not reproduced.
//
// What bounds it: bytes and atomics: 4 bytes of cotangent a (point, bone)
// pair, and for a pair with a non-zero cotangent 8 volume reads and up to 8
// float atomics into 3 MB of d(vols) that stay in L2. The order of the
// sums, and with it the last bits of the results, varies from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

struct Args {
  const float* vols;     // (K, D, H, W)
  const float* aff;      // (K, 12): A row-major, then t
  const float* boxes;    // cnl_min (3), cnl_scale (3)
  const float* axes;     // (3, G): grid coordinates along x, y, z
  const float* g;        // (K, G^3)
  float* dvols;          // (K, D, H, W)
  float* daff;           // (K, 12)
  int K, D, H, W, G;
  int is_bf16;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// One axis of the 2-hot lerp: clipped indices, weights (validity folded in)
// and d(weight)/d(frac) of both entries.
struct Lerp {
  int i0, i1;
  float a0, a1, s0, s1;
};

__device__ __forceinline__ Lerp axis_lerp(float q, float cmin, float cscale,
                                          int size, bool bf16_mode) {
  // the forward's expression, kept from being contracted into fma:
  // frac = (((q - cmin) * cscale - 1) + 1) * 0.5 * (size - 1)
  const float c = __fadd_rn(__fmul_rn(__fsub_rn(q, cmin), cscale), -1.0f);
  const float frac =
      __fmul_rn(__fmul_rn(__fadd_rn(c, 1.0f), 0.5f), (float)(size - 1));
  const float f0 = floorf(frac);
  float w = frac - f0;
  float w1m = 1.0f - w;
  if (bf16_mode) {
    w = round_bf16(w);
    w1m = round_bf16(1.0f - w);
  }
  const float v0 = (f0 >= 0.0f && f0 <= (float)(size - 1)) ? 1.0f : 0.0f;
  const float v1 =
      (f0 + 1.0f >= 0.0f && f0 + 1.0f <= (float)(size - 1)) ? 1.0f : 0.0f;
  Lerp l;
  l.i0 = (int)fminf(fmaxf(f0, 0.0f), (float)(size - 1));
  l.i1 = (int)fminf(fmaxf(f0 + 1.0f, 0.0f), (float)(size - 1));
  l.a0 = w1m * v0;
  l.a1 = w * v1;
  l.s0 = -v0;
  l.s1 = v1;
  return l;
}

__global__ void __launch_bounds__(THREADS)
resample_bwd_kernel(const Args a) {
  __shared__ float red[THREADS / 32][12];
  const int k = blockIdx.y;
  const long long n_pts = (long long)a.G * a.G * a.G;
  const long long pt = (long long)blockIdx.x * THREADS + threadIdx.x;
  const float gv = pt < n_pts ? a.g[(size_t)k * n_pts + pt] : 0.0f;
  if (!__syncthreads_or(gv != 0.0f)) return;

  float acc[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) acc[i] = 0.0f;

  if (gv != 0.0f) {
    const int G = a.G;
    const int xi = (int)(pt % G);
    const int yi = (int)((pt / G) % G);
    const int zi = (int)(pt / ((long long)G * G));
    const float p[3] = {a.axes[xi], a.axes[G + yi], a.axes[2 * G + zi]};
    const float* A = a.aff + k * 12;
    float q[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      q[i] = fmaf(p[2], A[3 * i + 2],
                  fmaf(p[1], A[3 * i + 1], p[0] * A[3 * i])) + A[9 + i];
    const bool bm = a.is_bf16 != 0;
    const Lerp lx = axis_lerp(q[0], a.boxes[0], a.boxes[3], a.W, bm);
    const Lerp ly = axis_lerp(q[1], a.boxes[1], a.boxes[4], a.H, bm);
    const Lerp lz = axis_lerp(q[2], a.boxes[2], a.boxes[5], a.D, bm);
    const int zs[2] = {lz.i0, lz.i1}, ys[2] = {ly.i0, ly.i1},
              xs[2] = {lx.i0, lx.i1};
    const float az[2] = {lz.a0, lz.a1}, ay[2] = {ly.a0, ly.a1},
                ax[2] = {lx.a0, lx.a1};
    const float sz[2] = {lz.s0, lz.s1}, sy[2] = {ly.s0, ly.s1},
                sx[2] = {lx.s0, lx.s1};
    const size_t vol_off = (size_t)k * a.D * a.H * a.W;
    const float* vol = a.vols + vol_off;
    float* dvol = a.dvols + vol_off;
    float dfx = 0.0f, dfy = 0.0f, dfz = 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int l = 0; l < 2; ++l) {
          const size_t idx = ((size_t)zs[i] * a.H + ys[j]) * a.W + xs[l];
          float v = vol[idx];
          if (bm) v = round_bf16(v);
          const float w = az[i] * ay[j] * ax[l];
          if (w != 0.0f) atomicAdd(dvol + idx, gv * w);
          dfz += sz[i] * ay[j] * ax[l] * v;
          dfy += az[i] * sy[j] * ax[l] * v;
          dfx += az[i] * ay[j] * sx[l] * v;
        }
    // frac = (q - cmin) * cscale * 0.5 * (size - 1)
    const float dq[3] = {gv * dfx * a.boxes[3] * 0.5f * (float)(a.W - 1),
                         gv * dfy * a.boxes[4] * 0.5f * (float)(a.H - 1),
                         gv * dfz * a.boxes[5] * 0.5f * (float)(a.D - 1)};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) acc[3 * i + j] = dq[i] * p[j];
      acc[9 + i] = dq[i];
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    float v = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < 12) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) v += red[w][threadIdx.x];
    if (v != 0.0f) atomicAdd(a.daff + k * 12 + threadIdx.x, v);
  }
}

}  // namespace

extern "C" {

// vols (K, D, H, W) f32; aff (K, 12) f32 (A row-major, then t); boxes (6,)
// f32 (canonical bbox min, scale); axes (3, G) f32 grid coordinates; g
// (K, G^3) f32. dvols (K, D, H, W) and daff (K, 12) f32 are added to and
// must come in zeroed. Returns a cudaError_t (0 on success).
int resample_backward(const float* vols, const float* aff, const float* boxes,
                      const float* axes, const float* g, float* dvols,
                      float* daff, int K, int D, int H, int W, int G,
                      int is_bf16, void* stream) {
  if (K <= 0 || G <= 0) return 0;
  if (K > 65535 || D < 1 || H < 1 || W < 1) return -1;
  Args a;
  a.vols = vols;
  a.aff = aff;
  a.boxes = boxes;
  a.axes = axes;
  a.g = g;
  a.dvols = dvols;
  a.daff = daff;
  a.K = K; a.D = D; a.H = H; a.W = W; a.G = G;
  a.is_bf16 = is_bf16;
  const long long n_pts = (long long)G * G * G;
  dim3 grid((unsigned)((n_pts + THREADS - 1) / THREADS), (unsigned)K);
  resample_bwd_kernel<<<grid, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
