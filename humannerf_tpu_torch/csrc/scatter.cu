// Backward of the packed-volume sample gather, for sm_90a.
//
// Replaces the Pallas TPU kernel humannerf_tpu/ops/pallas_scatter.py
// (`_scatter_call` -> `_slot_kernel`, plus the 8-way unpack-add around it).
// The forward read, for each sample, the eight corner voxels of its cell in
// the fused volume U (G, G, G, 16) and blended them with trilinear weights.
// Its transpose adds, for each live and in-range sample and each corner k,
//
//   dU[corner_k(sample)][c] += w8[k] * d_acc[sample][c],   c < 16
//
// The base corner is clipped to G - 2 on each axis, so all eight corners are
// voxels of U itself and the edge replication of the packed layout never
// contributes. Channels 13..15 of U are padding; their cotangent is zero on
// the training path and is added like any other.
//
// It takes the training step's tensors as they are: the base-voxel ids as
// int64, the validity mask as bool bytes and the cotangent (N, 16) float32
// unmasked. A sample's validity byte is read first; an invalid sample's id,
// fractions and cotangent are never read, so whatever its cotangent holds
// (NaN included) never reaches dU.
//
// What bounds it on the H100: the L2's atomic operations, then the latency
// of its loads. A live sample reads 85 bytes but adds 8 corners x 64 bytes,
// and the L2 settles ~90 G atomic adds a second at scattered addresses,
// float4 ones as fast as float ones (scripts/atomic_rates.py); taking the
// atomics out saves about a quarter of the kernel's time
// (scripts/k34_ablation.py).
// Design: four threads a sample, one per four-channel quad, each adding
// with the 16-byte vector atomicAdd(float4*) of sm_90: 32 atomic
// instructions a live sample, against 8 x 13 scalar ones in one thread a
// channel. A warp holds 8 consecutive samples (of one ray); a quad whose
// sample continues the previous sample's base voxel hands its cotangent and
// fractions by shuffles to the first sample of the run, and only that one
// adds: one set of 8 corner atomics a run. A quad whose cotangent is
// exactly zero adds nothing (exact), which is most of them. No sort and no
// segment table: the order of the sums, and with it the last bits of dU,
// varies from run to run. Products are formed in f32 in both compute modes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 16;        // channels of a voxel row
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
scatter_kernel(const long long* __restrict__ flat,
               const float* __restrict__ w3,
               const uint8_t* __restrict__ valid,
               const float4* __restrict__ d_acc, float4* dU, long long n,
               int G) {
  const int lane = threadIdx.x & 31;
  const int q = lane & 3;                       // channel quad
  const long long s = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 2;
  // validity first: an invalid sample's other inputs are never read
  const bool ok = s < n && valid[s] != 0;
  float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
  long long v = -1;
  float wx = 0.f, wy = 0.f, wz = 0.f;
  if (ok) {
    d = d_acc[s * (CH / 4) + q];
    v = flat[s];
    wx = w3[s * 3 + 0];
    wy = w3[s * 3 + 1];
    wz = w3[s * 3 + 2];
  }
  const bool act = ok && (d.x != 0.f || d.y != 0.f || d.z != 0.f
                          || d.w != 0.f);
  // runs: this quad continues the run of the warp's previous sample
  // (lane - 4) when both have work and one base voxel
  const long long v_prev = __shfl_up_sync(FULL, v, 4);
  const bool act_prev = __shfl_up_sync(FULL, act, 4);
  const bool member = lane >= 4 && act && act_prev && v == v_prev;
  const unsigned members = __ballot_sync(FULL, member);
  // a head adds its run: itself and the members that follow it
  int len = 0;
  if (act && !member) {
    len = 1;
    while (lane + 4 * len < 32 && (members >> (lane + 4 * len)) & 1u) ++len;
  }
  const int longest = __reduce_max_sync(FULL, len);
  float4 sum[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) sum[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < longest; ++j) {
    // every lane shuffles; a head takes the j-th sample of its run
    const float4 dj = make_float4(__shfl_down_sync(FULL, d.x, 4 * j),
                                  __shfl_down_sync(FULL, d.y, 4 * j),
                                  __shfl_down_sync(FULL, d.z, 4 * j),
                                  __shfl_down_sync(FULL, d.w, 4 * j));
    const float xj = __shfl_down_sync(FULL, wx, 4 * j);
    const float yj = __shfl_down_sync(FULL, wy, 4 * j);
    const float zj = __shfl_down_sync(FULL, wz, 4 * j);
    if (j < len) {
      const float fz[2] = {1.0f - zj, zj};
      const float fy[2] = {1.0f - yj, yj};
      const float fx[2] = {1.0f - xj, xj};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        // same association as the forward's corner weights: (z * y) * x
        const float w = fz[k >> 2] * fy[(k >> 1) & 1] * fx[k & 1];
        sum[k].x = fmaf(w, dj.x, sum[k].x);
        sum[k].y = fmaf(w, dj.y, sum[k].y);
        sum[k].z = fmaf(w, dj.z, sum[k].z);
        sum[k].w = fmaf(w, dj.w, sum[k].w);
      }
    }
  }
  if (len > 0) {
    float4* row = dU + v * (CH / 4) + q;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
      atomicAdd(row + ((size_t)(dz * G + dy) * G + dx) * (CH / 4), sum[k]);
    }
  }
}

}  // namespace

extern "C" {

// flat (n,) int64 base-corner voxel ids, w3 (n, 3) f32 fractions (x, y, z),
// valid (n,) bytes (bool: in range and live), d_acc (n, 16) f32; dU
// (G^3, 16) f32 is added to and must come in zeroed. Returns a cudaError_t
// (0 on success).
int scatter_volume_backward(const long long* flat, const float* w3,
                            const uint8_t* valid, const float* d_acc,
                            float* dU, long long n, int G, void* stream) {
  if (n <= 0) return 0;
  if (G < 2) return -1;
  const long long blocks = (n * 4 + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return -1;
  scatter_kernel<<<(unsigned)blocks, THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      flat, w3, valid, reinterpret_cast<const float4*>(d_acc),
      reinterpret_cast<float4*>(dU), n, G);
  return (int)cudaGetLastError();
}

}  // extern "C"
