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
// (channels 13..15 of U are padding: the renderer never reads them, so their
// cotangent is zero and costs nothing here). The base corner is
// clipped to G - 2 on each axis, so all eight corners are voxels of U itself
// and the edge replication of the packed layout never contributes.
//
// What bounds it: bytes and atomics. A sample reads 81 bytes (base voxel id,
// three fractions, a validity byte, 16 cotangent floats) and makes up to
// 8 x 13 float atomics into a 7 MB volume that stays in L2. Design: one
// thread per (sample, channel), 16 threads a sample, so that a corner's
// adds go to one 64-byte row; a thread whose cotangent is exactly zero adds
// nothing (exact: it would add zeros), which is most of them, since samples
// in empty space carry zero cotangents. No sort and no segment table: the
// order of the sums, and with it the last bits of dU, varies from run to run.
// Products are formed in f32 in both compute modes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 16;        // channels of a voxel row
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
scatter_kernel(const int* __restrict__ flat, const float* __restrict__ w3,
               const uint8_t* __restrict__ valid,
               const float* __restrict__ d_acc, float* dU, long long n,
               int G) {
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long s = tid >> 4;
  const int c = (int)(tid & 15);
  if (s >= n || valid[s] == 0) return;
  const float d = d_acc[s * CH + c];
  if (d == 0.0f) return;
  const float wx = w3[s * 3 + 0];
  const float wy = w3[s * 3 + 1];
  const float wz = w3[s * 3 + 2];
  const float fz[2] = {1.0f - wz, wz};
  const float fy[2] = {1.0f - wy, wy};
  const float fx[2] = {1.0f - wx, wx};
  float* base = dU + (size_t)flat[s] * CH + c;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dz = k >> 2, dy = (k >> 1) & 1, dxx = k & 1;
    // same association as the forward's corner weights: (z * y) * x
    const float w = fz[dz] * fy[dy] * fx[dxx];
    atomicAdd(base + ((size_t)(dz * G + dy) * G + dxx) * CH, w * d);
  }
}

}  // namespace

extern "C" {

// flat (n,) int32 base-corner voxel ids, w3 (n, 3) f32 fractions (x, y, z),
// valid (n,) bytes (in range and live), d_acc (n, 16) f32; dU (G^3, 16) f32
// is added to and must come in zeroed. Returns a cudaError_t (0 on success).
int scatter_volume_backward(const int* flat, const float* w3,
                            const uint8_t* valid, const float* d_acc,
                            float* dU, long long n, int G, void* stream) {
  if (n <= 0) return 0;
  if (G < 2) return -1;
  const long long blocks = (n * CH + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return -1;
  scatter_kernel<<<(unsigned)blocks, THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(flat, w3, valid,
                                                        d_acc, dU, n, G);
  return (int)cudaGetLastError();
}

}  // extern "C"
