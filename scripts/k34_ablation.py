"""What holds kernels K3 (csrc/resample_bwd.cu) and K4 (csrc/scatter.cu):
time each with one of its costs taken out.

    python3 scripts/k34_ablation.py               # on a machine with the card and nvcc
    python3 scripts/k34_ablation.py --tree DIR    # the sources and package of another checkout

Builds resample_bwd.cu and scatter.cu alone (one nvcc each, all started
together) from the checkout's sources, once as they are and once for each
text patch below that removes one cost while keeping the kernel's
synchronisation intact (the results of a patched kernel are wrong; only its
time is read). It knows two designs of each kernel and picks, per source,
the one whose anchor the source holds:

  K3, "atomic" (one thread a (point, bone), g bone-major)
    no_dvol_atomics   the eight d(vols) atomics of a pair are not issued
    no_daff_atomics   the block's twelve dA / dT atomics are not issued
  K3, "cluster" (one cluster a bone, a private fixed-point d(vols) copy a
  block)
    no_dvol_adds      the eight shared-memory adds of a pair are not issued
    no_cluster_sum    the cluster's slab sum over DSMEM reads one copy
    no_vol_reads      the eight volume reads of a pair read one voxel
  K4, "scalar" (16 threads a sample, scalar atomics)
    no_atomics        the atomics are not issued
  K4, "quad" (4 threads a sample, float4 atomics, runs merged by shuffles)
    no_atomics        the vector atomics are not issued
    no_merge          every sample adds its own corners (no run merging)

Each variant runs the backward node of `resample_all_bones` and of
`sample_packed_grad` as the training step calls it, at the `kernels` phase's
training shapes (default config, K = 24 bones, 32^3 volumes, G = 48;
786 432 samples), in bf16 and f32 compute, under torch.profiler: the
kernel's device time and every kernel of the node by name (the wrapper's
glue: copies, fills, casts). Prints one JSON line a variant, with the card's
name and power limit.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PATCHES = {
    "resample_bwd.cu": {
        "atomic": ("resample_bwd_kernel(const Args a)", {
            "no_dvol_atomics": [(
                "if (w != 0.0f) atomicAdd(dvol + idx, gv * w);",
                "if (w != 0.0f && a.K < 0) atomicAdd(dvol + idx, gv * w);")],
            "no_daff_atomics": [(
                "if (v != 0.0f) atomicAdd(a.daff",
                "if (v != 0.0f && a.K < 0) atomicAdd(a.daff")],
        }),
        "cluster": ("resample_bwd_kernel(const __grid_constant__ Args a)", {
            "no_dvol_adds": [(
                "if (held && w != 0.0f)\n",
                "if (held && w != 0.0f && a.K < 0)\n")],
            "no_cluster_sum": [(
                "for (int r = 0; r < nrank; ++r) {",
                "for (int r = 0; r < (a.K < 0 ? nrank : 1); ++r) {")],
            "no_vol_reads": [(
                "v = __ldg(vol + ((size_t)zz * a.H + yy) * a.W + xx);",
                "v = __ldg(vol + (a.K < 0 ? ((size_t)zz * a.H + yy) * a.W + xx "
                ": 0));")],
        }),
    },
    "scatter.cu": {
        "scalar": ("scatter_kernel(const int* __restrict__ flat", {
            "no_atomics": [(
                "    atomicAdd(base + ((size_t)(dz * G + dy) * G + dxx) * CH, "
                "w * d);",
                "    if (n < 0) atomicAdd(base + ((size_t)(dz * G + dy) * G "
                "+ dxx) * CH, w * d);")],
        }),
        "quad": ("scatter_kernel(const long long* __restrict__ flat", {
            "no_atomics": [(
                "if (len > 0) {",
                "if (len > 0 && n < 0) {")],
            "no_merge": [(
                "const bool member = lane >= 4 && act",
                "const bool member = n < 0 && lane >= 4 && act")],
        }),
    },
}

ITERS = 10


def patched_sources(src_dir, work):
    """{variant: csrc dir}: 'as_is' plus one dir per patch of the design
    each source holds."""
    dirs = {"as_is": []}
    designs = {}
    for fname, by_design in PATCHES.items():
        text = open(os.path.join(src_dir, fname)).read()
        found = [d for d, (anchor, _) in by_design.items() if anchor in text]
        if len(found) != 1:
            raise RuntimeError(f"{fname}: no known design ({found})")
        designs[fname] = found[0]
        for var, patches in by_design[found[0]][1].items():
            out = text
            for old, new in patches:
                if old not in out:
                    raise RuntimeError(f"{fname} {var}: anchor not found")
                out = out.replace(old, new)
            dirs[f"{fname.split('.')[0]}:{var}"] = [(fname, out)]
    made = {}
    for name, files in dirs.items():
        d = os.path.join(work, name.replace(":", "_"), "csrc")
        os.makedirs(d)
        for fname in PATCHES:
            shutil.copy(os.path.join(src_dir, fname), d)
        for fname, text in files:
            with open(os.path.join(d, fname), "w") as f:
                f.write(text)
        made[name] = d
    return made, designs


def build_all(dirs, nvcc, nvcc_flags):
    """One nvcc a source, all at once; one link a variant. -> {variant:
    library path}."""
    procs = []
    for name, d in dirs.items():
        for fname in PATCHES:
            src = os.path.join(d, fname)
            procs.append((name, subprocess.Popen(
                [nvcc, *nvcc_flags, "-c", src, "-o", src + ".o"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for name, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out[-3000:]}")
    libs = {}
    for name, d in dirs.items():
        lib = os.path.join(d, "libk34.so")
        objs = [os.path.join(d, f + ".o") for f in PATCHES]
        r = subprocess.run([nvcc, "-shared", "-o", lib, *objs],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"{name}: link failed\n{r.stdout}{r.stderr}")
        libs[name] = lib
    return libs


class _Partial:
    """A loaded library in which symbols that the two sources do not define
    are stand-ins: the package's loader sets the argument types of all six
    kernels' functions."""

    def __init__(self, lib):
        self.__dict__["_lib"] = lib

    def __getattr__(self, name):
        try:
            return getattr(self._lib, name)
        except AttributeError:
            stand_in = types.SimpleNamespace()
            self.__dict__[name] = stand_in
            return stand_in


def use_library(_build, path):
    """Point the package's kernel loader at `path`."""
    real = _build.ctypes
    _build.ctypes = types.SimpleNamespace(
        CDLL=lambda p: _Partial(real.CDLL(p)), c_void_p=real.c_void_p,
        c_int=real.c_int, c_longlong=real.c_longlong)
    _build.build = lambda: path
    _build._lib = None
    try:
        _build.load_library()
    finally:
        _build.ctypes = real


def node_profile(torch, make, iters):
    """Kernels of `iters` autograd backwards of make()'s graph, by name ->
    {name: device ms per backward}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out, cot, leaves = make()
    torch.autograd.grad(out, leaves, cot)
    graphs = [make() for _ in range(iters)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for out, cot, leaves in graphs:
            torch.autograd.grad(out, leaves, cot)
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3 / iters
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose sources and package are timed")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import chip_smoke as cs
    from humannerf_tpu_torch.config import make_cfg
    from humannerf_tpu_torch.models.network import HumanNeRF
    from humannerf_tpu_torch.ops import _build, fused_warp

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    work = tempfile.mkdtemp(dir=os.path.join(ROOT, "humannerf_tpu_torch",
                                             "_build"))
    try:
        dirs, designs = patched_sources(
            os.path.join(tree, "humannerf_tpu_torch", "csrc"), work)
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        libs = build_all(dirs, _build._find_nvcc(), flags)

        dev = torch.device("cuda")
        cfg = make_cfg(opts=["eval.metrics", "['psnr', 'ssim']"])
        net = HumanNeRF(cfg)
        params = cs.smoke_params(net, cs.SEED)
        shapes = cs.training_shapes(net, params, cs.train_item(cfg,
                                                                cs.SEED + 10))
        G = cfg.warp.grid_size
        K = shapes["vols"].shape[0]
        gen = torch.Generator().manual_seed(cs.SEED + 3)
        touched = shapes["U"][..., 12].float().reshape(-1) > 0
        g3 = torch.randn((G ** 3, K), generator=gen).to(dev) \
            * touched[:, None].float()
        boxes = (shapes["cnl_min"], shapes["cnl_scale"], shapes["obs_min"],
                 shapes["obs_max"])
        with torch.no_grad():
            _, (_, _, valid, _) = fused_warp.packed_acc(
                fused_warp.build_packed_volume(shapes["U"]), shapes["pts"],
                shapes["obs_min"], shapes["obs_max"], shapes["live_band"])
        n = shapes["pts"].shape[0]
        d_acc = torch.randn((n, 16), generator=gen).to(dev) \
            * valid[:, None].float()
        print(json.dumps({"device": smi, "designs": designs, "grid": G,
                          "bones": K, "samples": n,
                          "live_pair_share": float((g3 != 0).float().mean()),
                          "valid_share": float(valid.float().mean())}),
              flush=True)

        for dt_name, dt in (("bf16", torch.bfloat16),
                            ("f32", torch.float32)):
            U = shapes["U"].to(dt)

            def k3():
                leaves = [t.detach().clone().requires_grad_(True)
                          for t in (shapes["vols"], shapes["Rs"],
                                    shapes["Ts"])]
                return fused_warp.resample_all_bones(
                    *leaves, *boxes, G, dt), g3, leaves

            def k4():
                Ul = U.detach().clone().requires_grad_(True)
                acc = fused_warp._PackedSampleAcc.apply(
                    Ul, shapes["pts"], shapes["obs_min"], shapes["obs_max"],
                    shapes["live_band"])
                return acc, d_acc, [Ul]
            for name, lib in libs.items():
                use_library(_build, lib)
                row = {"variant": name, "dtype": dt_name, "device": smi}
                for key, make, kname in (("k3", k3, "resample_bwd_kernel"),
                                         ("k4", k4, "scatter_kernel")):
                    if name != "as_is" and not name.startswith(
                            "resample" if key == "k3" else "scatter"):
                        continue
                    rows = [node_profile(torch, make, ITERS)
                            for _ in range(3)]
                    row[key] = {
                        "kernel_ms": [sum(v for k, v in r.items()
                                          if kname in k) for r in rows],
                        "node_ms": [sum(r.values()) for r in rows],
                        "node_kernels": {k: round(float(np.mean(
                            [r.get(k, 0.0) for r in rows])), 5)
                            for k in rows[0]}}
                print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
