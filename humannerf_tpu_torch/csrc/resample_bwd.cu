// Backward of the all-bone observation-grid weight resample, for sm_90a.
//
// Replaces the Pallas TPU kernels humannerf_tpu/ops/pallas_resample.py
// (`_bwd_call` -> `_bwd_kernel` and `_bwd_kernel_win`). The forward sampled
// each of K bone weight volumes (D, H, W) trilinearly (zeros outside,
// corners aligned) at the G^3 observation-grid points warped by the bone's
// affine q = A_k p + t_k. Given g (G^3, K), the cotangent of the samples in
// the layout autograd hands it, this kernel computes
//
//   d(vols)[k][corner] = sum over points of g * (the corner's lerp weights)
//   dA[k] = sum dq p^T,  dT[k] = sum dq,   dq = g * d(sample)/dq
//
// It recomputes the fractional coordinates and the 2-hot lerps exactly as
// the forward formed them (in bf16 mode the lerp weights and the volume
// values are rounded to bf16, and the rounding is differentiated straight
// through). The bone-support skip of the TPU kernel (exact only through the
// softmax that follows) is not reproduced.
//
// What bounds it on the H100: the d(vols) adds, then the work of a pair.
// A (point, bone) pair with a non-zero cotangent makes 8 adds, and at
// G = 48 over 32 voxels a side about 3.4 grid points share a voxel, so
// neighbouring pairs meet on the same addresses; as global atomics they
// serialise in L2. Its bytes (g once, the volumes once, d(vols) once) take
// ~5 us; the work of a pair (coordinates, three lerps, eight volume reads,
// eight adds, dA and dT) takes longer on the SMs that run it.
//
// Design: one thread-block cluster per bone (and z-chunk of the bone's
// volume, where one block cannot hold a whole volume), one block an SM.
// Every block keeps a private copy of its bone's d(vols) (the chunk's
// z-planes) in shared memory, 128 KB at 32^3, and adds its share of the
// grid points there. The copy is 32-bit fixed point: shared memory adds
// integers natively, while a float add there compiles to a compare-and-swap
// loop with ~1/7 of the rate, and an add into another block's shared memory
// (DSMEM) has ~1/100 (scripts/atomic_rates.py); so DSMEM is used only to
// sum the copies at the end: after a cluster barrier, block r reads its
// slab from every copy and writes it to d(vols) once, scaled back to float,
// with plain coalesced stores. d(vols) needs no memset and sees no global
// atomic. The fixed-point scale is the largest power of two that keeps the
// bone's largest |g| times the most grid points one voxel can take under
// 2^30, from each bone's g extrema (one torch.aminmax in the wrapper): a
// term rounds to a step of at most 2^-29 of |g|max times that count of
// points, and the sum of integers does not depend on the order of the
// adds. The blocks of a cluster take interleaved runs of the grid points. A
// thread takes two points at a time, in phases (cotangents and
// coordinates, lerps, volume reads, adds), so that their loads overlap, and
// reads its bone's cotangent from the (G^3, K) rows: g needs no transposed
// copy; a zero cotangent adds nothing (exact). dA and dT are summed in
// registers, then over the block (shuffles, shared memory), then over the
// cluster (DSMEM), and each (bone, entry) is written once: daff needs no
// memset either.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int BATCH = 2;           // points a thread takes at once
constexpr int MAX_CLUSTER = 16;    // the largest (non-portable) cluster

struct Args {
  const float* vols;     // (K, D, H, W)
  const float* Rs;       // (K, 3, 3), row-major
  const float* Ts;       // (K, 3)
  const float* cnl_min;  // (3,)
  const float* cnl_scale;  // (3,)
  const float* axes;     // (3, G): grid coordinates along x, y, z
  const float* g;        // (G^3, K)
  const float* gmin;     // (K,): each bone's smallest and largest g
  const float* gmax;     // (K,)
  float* dvols;          // (K, D, H, W)
  float* daff;           // (K, 12): dA row-major, then dT
  int K, D, H, W, G;
  int zc, nchunk;        // z-planes a cluster holds, chunks a bone
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

// Largest number of grid points whose trilinear support holds one voxel of
// bone k: the grid index maps to the volume's fractional index by the
// affine frac = J idx + b, so the points whose frac lies in a voxel's
// support [v - 1, v + 1]^3 have idx in a parallelepiped whose extent along
// index axis i is 2 sum_d |J^-1_id|; its integer points are at most the
// product over i of (extent + 1), here with one more for rounding. A
// singular J gives every point.
__device__ int support_points(const float (&A)[9], const float (&fq)[3],
                              const float* axes, int G) {
  float h[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    h[i] = G > 1 ? (axes[i * G + G - 1] - axes[i * G]) / (float)(G - 1)
                 : 0.0f;
  float J[3][3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int i = 0; i < 3; ++i) J[d][i] = fq[d] * A[3 * d + i] * h[i];
  const float c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1];
  const float c01 = J[1][2] * J[2][0] - J[1][0] * J[2][2];
  const float c02 = J[1][0] * J[2][1] - J[1][1] * J[2][0];
  const float det = J[0][0] * c00 + J[0][1] * c01 + J[0][2] * c02;
  long long m = 1;
  if (det == 0.0f || !isfinite(det)) return G * G * G;
  // J^-1 = adj(J) / det; row i of the adjugate, by cofactors
  const float adj[3][3] = {
      {c00, J[0][2] * J[2][1] - J[0][1] * J[2][2],
       J[0][1] * J[1][2] - J[0][2] * J[1][1]},
      {c01, J[0][0] * J[2][2] - J[0][2] * J[2][0],
       J[0][2] * J[1][0] - J[0][0] * J[1][2]},
      {c02, J[0][1] * J[2][0] - J[0][0] * J[2][1],
       J[0][0] * J[1][1] - J[0][1] * J[1][0]}};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float ext = 2.0f * (fabsf(adj[i][0]) + fabsf(adj[i][1])
                              + fabsf(adj[i][2])) / fabsf(det);
    const float cnt = floorf(ext * 1.001f) + 2.0f;
    m *= (long long)fminf(cnt, (float)G);
  }
  return (int)m;
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
resample_bwd_kernel(const __grid_constant__ Args a) {
  extern __shared__ int4 copy4[];          // this block's d(vols) chunk
  int* copy = reinterpret_cast<int*>(copy4);
  __shared__ float red[THREADS / 32][12];
  __shared__ float bsum[12];
  cg::cluster_group cluster = cg::this_cluster();
  const int nrank = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int k = blockIdx.y / a.nchunk;
  const int chunk = blockIdx.y - k * a.nchunk;
  const int z0 = chunk * a.zc;
  const int nz = min(a.zc, a.D - z0);
  const int HW = a.H * a.W;
  const int E = nz * HW;
  for (int i = threadIdx.x; i < (E + 3) / 4; i += THREADS)
    copy4[i] = make_int4(0, 0, 0, 0);
  __syncthreads();

  const int G = a.G;
  const int n_pts = G * G * G;
  const bool with_aff = chunk == 0;    // dA, dT are summed by chunk 0
  float A[9], T[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) A[i] = a.Rs[k * 9 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) T[i] = a.Ts[k * 3 + i];
  const float cmin[3] = {a.cnl_min[0], a.cnl_min[1], a.cnl_min[2]};
  const float csc[3] = {a.cnl_scale[0], a.cnl_scale[1], a.cnl_scale[2]};
  // d(frac)/dq per axis: frac = (q - cmin) * cscale * 0.5 * (size - 1)
  const float fq[3] = {csc[0] * 0.5f * (float)(a.W - 1),
                       csc[1] * 0.5f * (float)(a.H - 1),
                       csc[2] * 0.5f * (float)(a.D - 1)};
  // the fixed-point scale 2^sexp: |g|max * points * 2^sexp < 2^30
  const float gabs = fmaxf(a.gmax[k], -a.gmin[k]);
  int e2 = 0;
  frexpf(gabs * (float)support_points(A, fq, a.axes, G), &e2);
  const int sexp = max(-126, min(126, 30 - e2));
  const float scale = ldexpf(1.0f, sexp);
  const float* vol = a.vols + (size_t)k * a.D * HW;
  const float* gk = a.g + k;
  float s[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = 0.0f;

  // Block r of the cluster takes every nrank-th run of THREADS points, so
  // that the occupied part of the grid (the body) spreads evenly over the
  // blocks; the point index walks by nrank * THREADS and its (x, y, z)
  // digits walk with it. A thread takes BATCH points at a time in phases
  // (cotangents and coordinates, lerps, volume values, adds), so that each
  // phase's loads of all BATCH points are in flight together.
  const int step = nrank * THREADS;
  int pt = rank * THREADS + threadIdx.x;
  int xi = pt % G, yi = (pt / G) % G, zi = pt / (G * G);
  const int sx = step % G, sy = (step / G) % G, sz = step / (G * G);
  for (; gabs != 0.0f && pt < n_pts; pt += BATCH * step) {
    float gb[BATCH], p[BATCH][3];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      if (xi >= G) { xi -= G; ++yi; }
      if (yi >= G) { yi -= G; ++zi; }
      const int pb = pt + b * step;
      gb[b] = pb < n_pts ? __ldg(gk + (size_t)pb * a.K) : 0.0f;
      p[b][0] = a.axes[xi];
      p[b][1] = a.axes[G + yi];
      p[b][2] = a.axes[2 * G + zi];
      xi += sx;
      yi += sy;
      zi += sz;
    }
    bool any = false;
#pragma unroll
    for (int b = 0; b < BATCH; ++b) any = any || gb[b] != 0.0f;
    if (!any) continue;                  // most of the grid is empty space
    Lerp lx[BATCH], ly[BATCH], lz[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      float q[3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        q[i] = fmaf(p[b][2], A[3 * i + 2],
                    fmaf(p[b][1], A[3 * i + 1], p[b][0] * A[3 * i])) + T[i];
      lx[b] = axis_lerp(q[0], cmin[0], csc[0], a.W, BF16);
      ly[b] = axis_lerp(q[1], cmin[1], csc[1], a.H, BF16);
      lz[b] = axis_lerp(q[2], cmin[2], csc[2], a.D, BF16);
    }
    // corner c = (i, j, l): z bit 2, y bit 1, x bit 0
    float vv[BATCH][8];
#pragma unroll
    for (int b = 0; b < BATCH; ++b)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int zz = c & 4 ? lz[b].i1 : lz[b].i0;
        const int yy = c & 2 ? ly[b].i1 : ly[b].i0;
        const int xx = c & 1 ? lx[b].i1 : lx[b].i0;
        float v = 0.0f;
        if (with_aff && gb[b] != 0.0f)
          v = __ldg(vol + ((size_t)zz * a.H + yy) * a.W + xx);
        vv[b][c] = BF16 ? round_bf16(v) : v;
      }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const float gv = gb[b];
      if (gv == 0.0f) continue;
      const int zs[2] = {lz[b].i0, lz[b].i1}, ys[2] = {ly[b].i0, ly[b].i1},
                xs[2] = {lx[b].i0, lx[b].i1};
      const float az[2] = {lz[b].a0, lz[b].a1},
                  ay[2] = {ly[b].a0, ly[b].a1},
                  ax[2] = {lx[b].a0, lx[b].a1};
      const float sz_[2] = {lz[b].s0, lz[b].s1},
                  sy_[2] = {ly[b].s0, ly[b].s1},
                  sx_[2] = {lx[b].s0, lx[b].s1};
      const float gs = gv * scale;
      float dfx = 0.0f, dfy = 0.0f, dfz = 0.0f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int zl = zs[i] - z0;               // plane in this chunk
        const bool held = (unsigned)zl < (unsigned)nz;
        // this plane's bilinear sums, separably: along x, then y
        float X[2], Y[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* v = vv[b] + 4 * i + 2 * j;
          X[j] = fmaf(ax[1], v[1], ax[0] * v[0]);
          Y[j] = fmaf(sx_[1], v[1], sx_[0] * v[0]);
          const int row = (zl * a.H + ys[j]) * a.W;
#pragma unroll
          for (int l = 0; l < 2; ++l) {
            const float w = az[i] * ay[j] * ax[l];
            if (held && w != 0.0f)
              atomicAdd(copy + row + xs[l], __float2int_rn(gs * w));
          }
        }
        dfz = fmaf(sz_[i], fmaf(ay[1], X[1], ay[0] * X[0]), dfz);
        dfy = fmaf(az[i], fmaf(sy_[1], X[1], sy_[0] * X[0]), dfy);
        dfx = fmaf(az[i], fmaf(ay[1], Y[1], ay[0] * Y[0]), dfx);
      }
      const float dq[3] = {gv * dfx * fq[0], gv * dfy * fq[1],
                           gv * dfz * fq[2]};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
          s[3 * i + j] = fmaf(dq[i], p[b][j], s[3 * i + j]);
        s[9 + i] += dq[i];
      }
    }
  }

  // dA, dT: over the warp, the block, then (below) the cluster
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    float v = s[i];
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
    bsum[threadIdx.x] = v;
  }
  cluster.sync();             // every copy and every block sum is complete

  if (with_aff && rank == 0 && threadIdx.x < 12) {
    float v = 0.0f;
    for (int rr = 0; rr < nrank; ++rr)
      v += *cluster.map_shared_rank(bsum + threadIdx.x, rr);
    a.daff[k * 12 + threadIdx.x] = v;
  }
  // this block's slab of the chunk, summed over the cluster's copies (the
  // sum fits: the bound holds for all of the bone's points) and scaled back
  // (a non-finite cotangent makes the bone's d(vols) NaN, as a float sum
  // would make it non-finite)
  const float inv = isfinite(gabs) ? ldexpf(1.0f, -sexp) : __int_as_float(
      0x7fc00000);
  float* dst = a.dvols + ((size_t)k * a.D + z0) * HW;
  if (HW % 4 == 0) {
    const int E4 = E / 4;
    const int e0 = (int)((long long)E4 * rank / nrank);
    const int e1 = (int)((long long)E4 * (rank + 1) / nrank);
    for (int i = e0 + threadIdx.x; i < e1; i += THREADS) {
      int4 t = make_int4(0, 0, 0, 0);
      for (int r = 0; r < nrank; ++r) {
        const int4 v = cluster.map_shared_rank(copy4, r)[i];
        t.x += v.x; t.y += v.y; t.z += v.z; t.w += v.w;
      }
      reinterpret_cast<float4*>(dst)[i] = make_float4(
          t.x * inv, t.y * inv, t.z * inv, t.w * inv);
    }
  } else {
    const int e0 = (int)((long long)E * rank / nrank);
    const int e1 = (int)((long long)E * (rank + 1) / nrank);
    for (int i = e0 + threadIdx.x; i < e1; i += THREADS) {
      int t = 0;
      for (int r = 0; r < nrank; ++r)
        t += cluster.map_shared_rank(copy, r)[i];
      dst[i] = t * inv;
    }
  }
  cluster.sync();             // no block leaves while its copy is read
}

// How a launch cuts the bones' volumes: z-planes a cluster holds (as many
// as one block's shared memory takes), chunks a bone, dynamic shared memory.
struct Plan {
  int zc = 0, nchunk = 0, smem = 0;
};

int make_plan(int D, int H, int W, Plan* p) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const long long plane = (long long)H * W * 4;
  // the static arrays, and room for what cooperative_groups keeps
  const long long room = optin - (THREADS / 32 + 1) * 12 * 4 - 1024;
  if (plane > room) return -1;
  const int zc = (int)(room / plane < D ? room / plane : D);
  p->nchunk = (D + zc - 1) / zc;
  p->zc = (D + p->nchunk - 1) / p->nchunk;       // even chunks
  p->smem = (int)((p->zc * plane + 15) / 16 * 16);
  // both instantiations' limit, raised to the largest size asked for
  static int smem_set = 0;
  if (p->smem > smem_set) {
    for (auto kern : {resample_bwd_kernel<false>, resample_bwd_kernel<true>}) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return (int)e;
    }
    smem_set = p->smem;
  }
  return 0;
}

cudaLaunchConfig_t launch_config(int c, int clusters, int smem,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, clusters);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Blocks a cluster: the size that finishes the clusters in the fewest
// block-widths, i.e. the least ceil(clusters / active(c)) / c, where
// active(c) is how many clusters of c blocks the card holds at once.
// Cached for the last (clusters, shared memory) it was asked.
int pick_cluster(int clusters, int smem) {
  static int last_clusters = -1, last_smem = -1, last = 0;
  if (clusters == last_clusters && smem == last_smem) return last;
  int best = 0;
  double best_cost = 0.0;
  for (int c = 1; c <= MAX_CLUSTER; ++c) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        launch_config(c, clusters, smem, nullptr, &attr);
    int active = 0;
    if (cudaOccupancyMaxActiveClusters(&active, resample_bwd_kernel<false>,
                                       &cfg)
            != cudaSuccess || active <= 0) {
      cudaGetLastError();
      continue;
    }
    const double cost = (double)((clusters + active - 1) / active) / c;
    if (best == 0 || cost < best_cost) {
      best = c;
      best_cost = cost;
    }
  }
  last_clusters = clusters;
  last_smem = smem;
  last = best;
  return best;
}

}  // namespace

extern "C" {

// vols (K, D, H, W) f32; Rs (K, 3, 3) and Ts (K, 3) f32, the bones'
// affines; cnl_min, cnl_scale (3,) f32; axes (3, G) f32 grid coordinates;
// g (G^3, K) f32; gmin, gmax (K,) f32 the least and greatest entry of each
// column of g. Writes every entry of dvols (K, D, H, W) and daff (K, 12)
// f32 (dA row-major, then dT): neither needs zeroing. Returns a cudaError_t
// (0 on success).
int resample_backward(const float* vols, const float* Rs, const float* Ts,
                      const float* cnl_min, const float* cnl_scale,
                      const float* axes, const float* g, const float* gmin,
                      const float* gmax, float* dvols, float* daff, int K,
                      int D, int H, int W, int G, int is_bf16, void* stream) {
  if (K <= 0 || G <= 0) return 0;
  if (D < 1 || H < 1 || W < 1 || (long long)G * G * G > 2147483647LL)
    return -1;
  Plan plan;
  const int err = make_plan(D, H, W, &plan);
  if (err != 0) return err;
  if ((long long)K * plan.nchunk > 65535) return -1;
  const int clusters = K * plan.nchunk;
  const int c = pick_cluster(clusters, plan.smem);
  if (c == 0) return -1;

  Args a;
  a.vols = vols;
  a.Rs = Rs;
  a.Ts = Ts;
  a.cnl_min = cnl_min;
  a.cnl_scale = cnl_scale;
  a.axes = axes;
  a.g = g;
  a.gmin = gmin;
  a.gmax = gmax;
  a.dvols = dvols;
  a.daff = daff;
  a.K = K; a.D = D; a.H = H; a.W = W; a.G = G;
  a.zc = plan.zc; a.nchunk = plan.nchunk;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      c, clusters, plan.smem, static_cast<cudaStream_t>(stream), &attr);
  const cudaError_t e =
      is_bf16 ? cudaLaunchKernelEx(&cfg, resample_bwd_kernel<true>, a)
              : cudaLaunchKernelEx(&cfg, resample_bwd_kernel<false>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The launch resample_backward makes for these shapes: out[0] blocks a
// cluster, out[1] z-chunks a bone, out[2] bytes of dynamic shared memory a
// block. Returns what resample_backward would (0, or why it cannot launch).
int resample_backward_shape(int K, int D, int H, int W, int* out) {
  Plan plan;
  const int err = make_plan(D, H, W, &plan);
  if (err != 0) return err;
  out[0] = pick_cluster(K * plan.nchunk, plan.smem);
  out[1] = plan.nchunk;
  out[2] = plan.smem;
  return out[0] > 0 ? 0 : -1;
}

}  // extern "C"
