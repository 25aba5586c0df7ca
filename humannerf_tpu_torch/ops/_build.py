"""Build-and-load of the hand-written CUDA kernels in `csrc/`.

The sources are compiled at first use with `nvcc` for sm_90a into one
shared library with a plain C interface and loaded with `ctypes` (no
PyTorch headers, so a build takes seconds). The library lands in the
package's `_build/` directory, which git ignores, under a name keyed by a
hash of the sources and flags: an edited source builds anew, an unchanged
one is reused. One `nvcc` per source, all started together, then one link.

A failed build raises with the compiler's output; nothing here falls back
to anything.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built on this machine")


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # headers shared between sources count too
    for s in list(srcs) + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile csrc/*.cu if needed; return the shared library's path."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = _digest(srcs)
    lib_path = os.path.join(BUILD_DIR, f"libhnkernels_{tag}.so")
    if os.path.isfile(lib_path):
        return lib_path
    nvcc = _find_nvcc()
    procs, objs = [], []
    for s in srcs:
        obj = os.path.join(
            BUILD_DIR, f"{os.path.splitext(os.path.basename(s))[0]}_{tag}.o")
        objs.append(obj)
        procs.append((s, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", s, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for s, p in procs:
        out, _ = p.communicate()
        log.append(f"== {os.path.basename(s)} (rc {p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(os.path.basename(s))
    with open(os.path.join(BUILD_DIR, f"build_{tag}.log"), "w") as f:
        f.write("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = lib_path + f".tmp{os.getpid()}"
    link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    return lib_path


def load_library():
    """The loaded kernel library (built on first call), with argtypes set."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_mlp_tile.restype = ci
    lib.fused_mlp_max_depth.restype = ci
    lib.fused_mlp_blocks_per_sm.restype = ci
    lib.fused_mlp_blocks_per_sm.argtypes = [ci]
    lib.fused_mlp_smem_bytes.restype = ci
    lib.fused_mlp_smem_bytes.argtypes = [ci]
    lib.fused_mlp_bwd_smem_bytes.restype = ci
    lib.fused_mlp_bwd_smem_bytes.argtypes = [ci]
    lib.fused_mlp_forward.restype = ci
    lib.fused_mlp_forward.argtypes = [vp, vp, ll, vp, vp, ci, ci, vp, vp,
                                      vp, vp, vp, vp]
    lib.composite_forward.restype = ci
    lib.composite_forward.argtypes = [vp, vp, vp, vp, vp, vp, vp, ll, ci, vp]
    lib.fused_mlp_bwd_grid.restype = ci
    lib.fused_mlp_bwd_grid.argtypes = [ci]
    lib.fused_mlp_bwd_block_rows.restype = ci
    lib.fused_mlp_bwd_block_rows.argtypes = [ci]
    lib.fused_mlp_bwd_scratch_elems.restype = ll
    lib.fused_mlp_bwd_scratch_elems.argtypes = [ci, ci, vp, vp]
    lib.fused_mlp_backward.restype = ci
    lib.fused_mlp_backward.argtypes = [vp, vp, vp, ll, vp, vp, ci, ci, vp, vp,
                                       vp, vp, vp, ll, ci, vp, vp]
    lib.scatter_volume_backward.restype = ci
    lib.scatter_volume_backward.argtypes = [vp, vp, vp, vp, vp, ll, ci, vp]
    lib.resample_backward.restype = ci
    lib.resample_backward.argtypes = [vp] * 11 + [ci] * 6 + [vp]
    lib.resample_backward_shape.restype = ci
    lib.resample_backward_shape.argtypes = [ci, ci, ci, ci, vp]
    lib.trilerp_forward.restype = ci
    lib.trilerp_forward.argtypes = [vp, ci, vp, vp, vp, vp, vp, ll, ci, vp]
    _lib = lib
    return lib


def build_log() -> str:
    """Compiler output of the newest build in the build directory."""
    logs = sorted(glob.glob(os.path.join(BUILD_DIR, "build_*.log")),
                  key=os.path.getmtime)
    if not logs:
        return ""
    with open(logs[-1]) as f:
        return f.read()
