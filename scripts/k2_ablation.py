"""What holds kernel K2 (csrc/fused_mlp_bwd.cu, bf16): time it with one of
its costs taken out.

    python3 scripts/k2_ablation.py        # on a machine with the card and nvcc

Builds the kernel library several times from the sources in the checkout,
each time with one text patch that removes a cost while keeping the kernel's
synchronisation intact (the results of a patched kernel are wrong; only its
time is read):

  as_is          the sources unchanged
  no_atomics     the dW / dW_e 16-byte atomics are not issued
  small_chunks   every weight chunk copy moves 1 KB instead of its 8-32 KB
  small_h_loads  every stored layer read back from the scratch moves 1 KB
                 instead of its 16-64 KB

and times K2 bf16 (CUDA events, 3 rounds of 5 calls) at the `kernels`
phase's size: N = 786 432 samples, the default widths, 31 % of the
128-sample tiles live (drawn from a seed). Prints one JSON line a variant,
with the card's name and power limit.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "humannerf_tpu_torch", "csrc")

PATCHES = {
    "as_is": [],
    "no_atomics": [(
        "fused_mlp_bwd.cu",
        "      if (r < rows)\n        atomicAdd(reinterpret_cast<float4*>(",
        "      if (r < rows && rows < 0)\n"
        "        atomicAdd(reinterpret_cast<float4*>(")],
    "small_chunks": [(
        "fused_mlp_bwd.cu",
        "    if (out != nullptr) out[n] = Chunk{src, bytes, 0};",
        "    if (out != nullptr) out[n] = Chunk{src, 1024u, 0};")],
    "small_h_loads": [(
        "fused_mlp_bwd.cu",
        "      mbar_expect_tx(bar, bytes);\n      bulk_load(dst, src, bytes, bar);",
        "      mbar_expect_tx(bar, 1024u);\n      bulk_load(dst, src, 1024u, bar);")],
}

TIMER = r'''
import json, sys, torch
from humannerf_tpu_torch.ops import _build, fused_mlp
from humannerf_tpu_torch.models import mlps
_build.build = lambda: sys.argv[1]
dev = torch.device("cuda")
gen = torch.Generator().manual_seed(0)
plan = fused_mlp.Plan(nr_depth=6, nr_skips=(4,), nr_width=128, nr_multires=6,
                      cnl_depth=8, cnl_skips=(4,), cnl_width=256,
                      cnl_multires=10, skip_nr=False,
                      compute_dtype=torch.bfloat16)
params = {
    "non_rigid_mlp": mlps.init_nonrigid_mlp(
        gen, pos_embed_size=36, mlp_width=128, mlp_depth=6, skips=(4,),
        device=dev),
    "cnl_mlp": mlps.init_canonical_mlp(
        gen, input_ch=63, mlp_depth=8, mlp_width=256, skips=(4,),
        device=dev)}
N = 786432
x = (torch.randn((N, 3), generator=gen) * 0.5).to(dev)
live = (torch.rand((N // 128,), generator=gen) < 0.31).to(torch.int32).to(dev)
g = (torch.randn((N, 4), generator=gen) * 0.1).to(dev)
cc = (torch.randn((69,), generator=gen) * 0.1).to(dev)
ops = fused_mlp.kernel_operands(plan, params["non_rigid_mlp"],
                                params["cnl_mlp"], cc)
nets = fused_mlp.pack_kernel_weights(plan, ops, backward=True)
f = lambda: fused_mlp.launch_backward(plan, x, g, 4.3, live, nets)
f()
torch.cuda.synchronize()
ms = []
for _ in range(3):
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(5):
        f()
    e.record()
    torch.cuda.synchronize()
    ms.append(s.elapsed_time(e) / 5)
print(json.dumps({"k2_bf16_ms": ms, "live_tiles": int(live.sum())}))
'''


def build(name, patches, work):
    d = os.path.join(work, name)
    shutil.copytree(CSRC, os.path.join(d, "csrc"))
    for fname, old, new in patches:
        path = os.path.join(d, "csrc", fname)
        text = open(path).read()
        if old not in text:
            raise RuntimeError(f"{name}: patch anchor not found in {fname}")
        open(path, "w").write(text.replace(old, new))
    code = ("from humannerf_tpu_torch.ops import _build; "
            f"_build.CSRC_DIR = {os.path.join(d, 'csrc')!r}; "
            f"_build.BUILD_DIR = {os.path.join(d, 'build')!r}; "
            "print(_build.build())")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=dict(os.environ, PYTHONPATH=ROOT))


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    work = tempfile.mkdtemp(dir=os.path.join(ROOT, "humannerf_tpu_torch",
                                             "_build"))
    try:
        procs = {n: build(n, p, work) for n, p in PATCHES.items()}
        libs = {}
        for name, p in procs.items():
            out, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"{name}: build failed\n{out[-3000:]}")
            libs[name] = out.strip().splitlines()[-1]
        for name, lib in libs.items():
            r = subprocess.run([sys.executable, "-c", TIMER, lib], cwd=ROOT,
                               capture_output=True, text=True,
                               env=dict(os.environ, PYTHONPATH=ROOT))
            if r.returncode != 0:
                raise RuntimeError(f"{name}: {r.stderr[-2000:]}")
            print(json.dumps({"variant": name, "device": smi,
                              **json.loads(r.stdout.strip().splitlines()[-1])}),
                  flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
