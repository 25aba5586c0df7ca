"""Rates of the atomic adds the scatter kernels can choose from, on the card.

    python3 scripts/atomic_rates.py      # on a machine with the card and nvcc

Builds one small CUDA program (nvcc, sm_90a) and times, with CUDA events,
grids of one 512-thread block an SM (128 KB of shared memory a block, as
K3's d(vols) copy takes) that each make 1 024 adds a thread:

  smem_f32        atomicAdd(float*) on the block's shared memory, addresses
                  spread at random over 32 768 floats
  smem_f32_1024   the same with 1 024 threads a block
  smem_i32        atomicAdd(int*) on shared memory (fixed point), the same
                  addresses (each add of a thread's own value: an add of a
                  constant 1 compiles to a warp-aggregated increment)
  dsmem_f32       atomicAdd(float*) on the shared memory of a random block of
                  a 4-block cluster (distributed shared memory)
  global_f32      atomicAdd(float*) on global memory, random over 4 MB
  global_f32x4    atomicAdd(float4*) on global memory, random over 16 MB
  global_f32_row  atomicAdd(float*) on global memory, 16 lanes on one
                  64-byte row (K4's old pattern: one lane a channel)

and lists the SASS instructions the shared and cluster adds compile to
(cuobjdump). Prints one JSON line a variant (G adds a second; for float4,
G vector adds) with the card's name and power limit.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r'''
#include <cooperative_groups.h>
#include <cstdio>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

constexpr int ITERS = 1024;
constexpr int WORDS = 32768;

__device__ __forceinline__ unsigned step(unsigned h) {
  return h * 1664525u + 1013904223u;
}

template <typename T>
__global__ void smem_add(float* out) {
  extern __shared__ unsigned char raw[];
  T* s = reinterpret_cast<T*>(raw);
  for (int i = threadIdx.x; i < WORDS; i += blockDim.x) s[i] = T(0);
  __syncthreads();
  unsigned h = threadIdx.x * 2654435761u + blockIdx.x;
  for (int it = 0; it < ITERS; ++it) {
    h = step(h);
    atomicAdd(s + (h >> 17), T(h & 7) + T(1));
  }
  __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = (float)s[5];
}

__global__ void __cluster_dims__(4, 1, 1) dsmem_add(float* out) {
  extern __shared__ float s[];
  cg::cluster_group cl = cg::this_cluster();
  for (int i = threadIdx.x; i < WORDS; i += blockDim.x) s[i] = 0.f;
  cl.sync();
  unsigned h = threadIdx.x * 2654435761u + blockIdx.x;
  for (int it = 0; it < ITERS; ++it) {
    h = step(h);
    atomicAdd(cl.map_shared_rank(s, (h >> 3) & 3) + (h >> 17), 1.0f);
  }
  cl.sync();
  if (threadIdx.x == 0) out[blockIdx.x] = s[5];
}

__global__ void global_add(float* g) {
  unsigned h = threadIdx.x * 2654435761u + blockIdx.x;
  for (int it = 0; it < ITERS; ++it) {
    h = step(h);
    atomicAdd(g + (h >> 12), 1.f);
  }
}

__global__ void global_add4(float4* g) {
  unsigned h = threadIdx.x * 2654435761u + blockIdx.x;
  for (int it = 0; it < ITERS; ++it) {
    h = step(h);
    atomicAdd(g + (h >> 12), make_float4(1.f, 1.f, 1.f, 1.f));
  }
}

__global__ void global_add_row(float* g) {
  // the 16 lanes of a half-warp share h, so they add to one 64-byte row
  unsigned h = (threadIdx.x >> 4) * 2654435761u + blockIdx.x;
  for (int it = 0; it < ITERS; ++it) {
    h = step(h);
    atomicAdd(g + (h >> 16) * 16 + (threadIdx.x & 15), 1.f);
  }
}

template <typename K>
float time_ms(K launch) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  launch();
  cudaEventRecord(a);
  for (int r = 0; r < 5; ++r) launch();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  return ms / 5;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int blocks = sms / 4 * 4;
  float* buf;
  cudaMalloc(&buf, 1 << 26);
  const int smem = WORDS * 4;          // 128 KB: one block an SM
  cudaFuncSetAttribute(smem_add<float>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(smem_add<int>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(dsmem_add,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  struct Row { const char* name; double adds; float ms; };
  Row rows[7];
  int n = 0;
  double per_block = 512.0 * ITERS;
  rows[n++] = {"smem_f32", blocks * per_block, time_ms([&] {
    smem_add<float><<<blocks, 512, smem>>>(buf); })};
  rows[n++] = {"smem_f32_1024", blocks * 2 * per_block, time_ms([&] {
    smem_add<float><<<blocks, 1024, smem>>>(buf); })};
  rows[n++] = {"smem_i32", blocks * per_block, time_ms([&] {
    smem_add<int><<<blocks, 512, smem>>>(buf); })};
  rows[n++] = {"dsmem_f32", blocks * per_block, time_ms([&] {
    dsmem_add<<<blocks, 512, smem>>>(buf); })};
  rows[n++] = {"global_f32", 2 * sms * per_block, time_ms([&] {
    global_add<<<2 * sms, 512>>>(buf); })};
  rows[n++] = {"global_f32x4", 2 * sms * per_block, time_ms([&] {
    global_add4<<<2 * sms, 512>>>(reinterpret_cast<float4*>(buf)); })};
  rows[n++] = {"global_f32_row", 2 * sms * per_block, time_ms([&] {
    global_add_row<<<2 * sms, 512>>>(buf); })};
  const cudaError_t e = cudaDeviceSynchronize();
  for (int i = 0; i < n; ++i)
    printf("%s %.6f %.6f %s\n", rows[i].name, rows[i].ms,
           rows[i].adds / rows[i].ms / 1e6, cudaGetErrorString(e));
  return e == cudaSuccess ? 0 : 1;
}
'''


def main():
    sys.path.insert(0, ROOT)
    from humannerf_tpu_torch.ops import _build
    nvcc = _build._find_nvcc()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    try:
        src = os.path.join(work, "atomic_rates.cu")
        exe = os.path.join(work, "atomic_rates")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-o", exe, src], check=True)
        out = subprocess.run([exe], capture_output=True, text=True,
                             check=True).stdout
        for line in out.splitlines():
            name, ms, rate, status = line.split(maxsplit=3)
            print(json.dumps({"variant": name, "ms": float(ms),
                              "g_adds_per_s": float(rate), "status": status,
                              "device": smi}), flush=True)
        sass = subprocess.run(
            [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", exe],
            capture_output=True, text=True).stdout
        ops, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
            m = re.search(r"\b(ATOMS\.[\w.]+|ATOM\.[\w.]+|RED\w*\.[\w.]+)",
                          line)
            if m and fn:
                ops.setdefault(fn, set()).add(m.group(1))
        print(json.dumps({"sass_atomics": {k: sorted(v)
                                           for k, v in ops.items()}}))
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
