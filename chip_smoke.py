"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py            # needs one CUDA device and nvcc

Drives humannerf_tpu_torch's serving path (EvalRenderer.render_frame at the
default model's full width, seeded weights, the synthetic frame) a few
frames, on the default route and on the analytic-band route
(`pallas.analytic_bands true`, also through the render CLI), and its
training path (Trainer.train, 6
patches of 32 x 32 rays a step, LPIPS + MSE on seeded targets) a few steps,
builds the hand-written kernels from humannerf_tpu_torch/csrc/ and holds
each against its plain PyTorch version on the card at the shapes those paths
give it. Every phase
prints one JSON line; any mismatch, non-finite value, zero launch count,
build failure or missing CUDA device ends the run with a non-zero exit code.
The last line is
{"ok": true, "device": {...}} and the line before it lists every kernel
with its launches, error and times.

Optional: --phases device,build,kernels,... runs a subset (for bring-up);
the extra phases `profile`, `profile_analytic`, `profile_train` and
`profile_train_f32` (not run by default) trace one frame on the default
route / one frame on the analytic-band route / one bf16 / one float32
training step with torch.profiler and print where the time goes;
`step_accuracy` reads how far each kernel alone moves a bf16 step's
gradients from the float32 step's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from humannerf_tpu_torch import runtime
from humannerf_tpu_torch.config import make_cfg
from humannerf_tpu_torch.models.network import HumanNeRF
from humannerf_tpu_torch.ops import (_build, composite, fused_mlp,
                                     fused_warp, trilerp)
from humannerf_tpu_torch.ops.raymarch import raw2outputs, sample_along_rays
from humannerf_tpu_torch.train import checkpoint as ckpt
from humannerf_tpu_torch.train.trainer import (FRAME_KEYS, RAY_KEYS,
                                                EvalRenderer, Trainer,
                                                to_device_batch)
from humannerf_tpu_torch.utils.body import (approx_gaussian_bone_volumes,
                                            body_pose_to_body_RTs,
                                            get_canonical_global_tfms,
                                            skeleton_to_bbox)
from humannerf_tpu_torch.utils.tree import (flat_grads, flat_leaves, leafify,
                                            rel_l2)

# published dense peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

ALL_PHASES = ("device", "build", "kernels", "render", "render_f32",
              "render_composite", "checkpoint", "ignore_non_rigid",
              "render_analytic", "cli_analytic", "train", "train_f32", "train_resume")
EXTRA_PHASES = ("profile", "profile_analytic", "profile_train",
                "profile_train_f32", "step_accuracy")
CHUNK = 8192          # rays per block, as render.py caps it
N_RAYS = 65536        # rays per frame
N_FRAMES = 2          # requests, each with its own pose
N_PATCHES, PATCH = 6, 32      # a training step: 6 patches of 32 x 32 rays
TRAIN_RAYS = N_PATCHES * PATCH * PATCH
TRAIN_STEPS = 20
SEED = 0


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def synthetic_item(cfg, n_rays: int, seed: int) -> dict:
    """One dataset-item-shaped frame (numpy): a straight 24-joint skeleton
    under a seeded random pose, rays from one origin through a box around
    the body; near/far in units of |rays_d|."""
    rng = np.random.RandomState(seed)
    joints = np.zeros((24, 3), np.float32)
    joints[:, 1] = np.linspace(-0.6, 0.6, 24)
    poses = rng.uniform(-0.2, 0.2, 72).astype(np.float32)
    bbox = skeleton_to_bbox(joints)
    dst_Rs, dst_Ts = body_pose_to_body_RTs(poses, joints)
    origin = np.array([0.0, 0.0, -3.0], np.float32)
    tgt = rng.uniform(-0.5, 0.5, (n_rays, 3)).astype(np.float32)
    return {
        "dst_bbox_min_xyz": bbox["min_xyz"], "dst_bbox_max_xyz": bbox["max_xyz"],
        "dst_Rs": dst_Rs, "dst_Ts": dst_Ts,
        "cnl_gtfms": get_canonical_global_tfms(joints),
        "motion_weights_priors": approx_gaussian_bone_volumes(
            joints, bbox["min_xyz"], bbox["max_xyz"],
            grid_size=cfg.mweight_volume.volume_size),
        "dst_posevec": poses[3:] + 1e-2,
        "cnl_bbox_min_xyz": bbox["min_xyz"],
        "cnl_bbox_scale_xyz": 2.0 / (bbox["max_xyz"] - bbox["min_xyz"]),
        "bgcolor": np.array([10.0, 60.0, 200.0], np.float32),
        "rays_o": np.tile(origin, (n_rays, 1)),
        "rays_d": tgt - origin,
        "near": np.full((n_rays,), 0.7, np.float32),
        "far": np.full((n_rays,), 1.3, np.float32),
    }


def smoke_params(net: HumanNeRF, seed: int) -> dict:
    """init_params(seed) with the non-rigid output layer scaled up from its
    1e-5 init to 1e-3 (offsets of a few mm), so the offset branch is visible
    in every comparison without letting the canonical embedding's 2^9 top
    frequency turn bf16 rounding of the offset into noise."""
    params = net.init_params(seed)
    params["non_rigid_mlp"]["output"]["w"] *= 1e2
    return params


def time_ms(fn, warm: int, iters: int) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, kernel_key: str, iters: int) -> float:
    """Device time of one launch of the kernel whose name holds kernel_key,
    from torch.profiler over `iters` calls of fn. For a kernel much shorter
    than its wrapper's host work, which time_ms reads instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # the profiler drops a record now and then (on the H100, for the ~7 ms
    # backward kernel), and once in a while a whole window's records of a
    # short kernel: the window is taken again, at most twice. More records
    # than calls: the key names other kernels too
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [(e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel_key in e.key]
        seen = sum(c for _, c in rows)
        if 0 < seen <= iters:
            return sum(t for t, _ in rows) / 1e3 / seen
    fail(f"profiler saw {rows} launches of {kernel_key}, expected {iters}")


def node_device_ms(make, iters: int):
    """Device time of one autograd backward: every kernel launched by
    torch.autograd.grad(out, leaves, cot) for the (out, cot, leaves) that
    `make` returns, summed from torch.profiler and averaged over `iters`
    graphs, all built before the profiled window so that no forward kernel
    is counted. -> (ms, {kernel name: ms per backward})."""
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
    rows = {e.key[:60]: e.self_device_time_total / 1e3 / iters
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}
    del graphs
    return sum(rows.values()), dict(sorted(rows.items(), key=lambda r: -r[1]))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)          # card name and power limit, verbatim
    emit("device", nvidia_smi=line, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return line


def phase_build():
    t0 = time.time()
    lib = _build.load_library()
    log = _build.build_log()
    # ptxas -v: registers, spills and shared memory of every kernel
    usage, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            for key in ("fused_mlp_bwd_bf16_kernel", "fused_mlp_bwd_kernel",
                        "fused_mlp_bf16_kernel", "fused_mlp_kernel",
                        "composite", "scatter", "resample", "trilerp"):
                if key in name:
                    # K5 reads bf16 rows as unsigned short (mangled ItE)
                    name = key + ("<bf16>" if "bfloat" in name
                                  or "ItE" in name or "Lb1E" in name else
                                  "<f32>" if "IfE" in name
                                  or "Lb0E" in name else "")
                    break
        elif name and ("Used" in ln or "spill" in ln):
            usage.setdefault(name, []).append(
                ln.replace("ptxas info    :", "").strip())
    # K3's launch at the default shape: 24 bones of 32^3, one cluster each
    shape = (ctypes.c_int * 3)()
    err = lib.resample_backward_shape(24, 32, 32, 32, ctypes.addressof(shape))
    if err != 0:
        fail(f"K3 cannot launch at 24 x 32^3 (error {err})")
    emit("build", seconds=round(time.time() - t0, 2),
         sources=[os.path.relpath(s) for s in _build.sources()],
         k3_launch={"cluster_blocks": shape[0], "z_chunks": shape[1],
                    "smem_bytes": shape[2]},
         k1_blocks_per_sm={"bf16": lib.fused_mlp_blocks_per_sm(1),
                           "f32": lib.fused_mlp_blocks_per_sm(0)},
         k2_resident_blocks={"bf16": lib.fused_mlp_bwd_grid(1),
                             "f32": lib.fused_mlp_bwd_grid(0)},
         smem_bytes={"k1_bf16": lib.fused_mlp_smem_bytes(1),
                     "k1_f32": lib.fused_mlp_smem_bytes(0),
                     "k2_bf16": lib.fused_mlp_bwd_smem_bytes(1),
                     "k2_f32": lib.fused_mlp_bwd_smem_bytes(0)},
         ptxas=usage)


K1_VARIANTS = (("bf16", torch.bfloat16, False), ("f32", torch.float32, False),
               ("bf16,skip_nr", torch.bfloat16, True),
               ("f32,skip_nr", torch.float32, True))
# kernel vs plain version on the card, max abs over raw values of magnitude
# up to ~3. The two differ in summation order (and in folding the condition
# code in f32). f32: ~1e-6 relative per layer, amplified up to 2^9 by the
# canonical embedding's top frequency. bf16: such a difference can flip the
# bf16 rounding of an activation (2^-8 relative), same amplification; the
# plain bf16 version is itself this far from the f32 one.
K1_TOL = {torch.float32: 5e-4, torch.bfloat16: 8e-2}
K6_TOL = 1e-4   # log-space prefix sum vs cumprod, float32
# names of the fused-MLP kernels in a profiler trace, by compute type
K1_KEY = {torch.bfloat16: "fused_mlp_bf16_kernel",
          torch.float32: "fused_mlp_kernel"}
K2_KEY = {torch.bfloat16: "fused_mlp_bwd_bf16_kernel",
          torch.float32: "fused_mlp_bwd_kernel"}


def matmul_chain_ms(plan, n_rows: int, dev) -> float:
    """CUDA-event time of the plan's hidden-layer products (6 non-rigid + 8
    canonical at the default widths; skip layers with their concatenated
    input) as torch.matmul in the plan's compute type over n_rows rows: a
    yardstick of what the library makes of K1's shapes. float32 runs with
    TF32 off, as K1 computes. The port never calls it."""
    nets = [(plan.cnl_depth, plan.cnl_width, plan.cnl_embed_dim,
             plan.cnl_skips)]
    if not plan.skip_nr:
        nets.append((plan.nr_depth, plan.nr_width, plan.nr_embed_dim,
                     plan.nr_skips))
    shapes = []
    for depth, width, edim, skips in nets:
        shapes.append((edim, width))
        shapes += [(width + (edim if li in skips else 0), width)
                   for li in range(1, depth)]
    dt = plan.compute_dtype
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ins = [torch.randn((n_rows, k), generator=gen, device=dev, dtype=dt)
           for k, _ in shapes]
    ws = [torch.randn((k, n), generator=gen, device=dev, dtype=dt)
          for k, n in shapes]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ms = time_ms(lambda: [torch.matmul(a, w) for a, w in zip(ins, ws)],
                     warm=2, iters=10)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del ins, ws
    return ms


def phase_kernels(net: HumanNeRF, params: dict, n_rays: int) -> dict:
    dev = net.device
    S = net.n_samples
    N = n_rays * S
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    x = (torch.randn((N, 3), generator=gen) * 0.5).to(dev)
    cc = (torch.randn((69,), generator=gen) * 0.1).to(dev)
    n_tiles = -(-N // fused_mlp.TILE)
    # a mix of live and dead tiles: a live head, then every third tile
    live = torch.zeros((n_tiles,), dtype=torch.int32)
    live[: n_tiles // 5] = 1
    live[n_tiles // 5:: 3] = 1
    live = live.to(dev)
    live_frac = float(live.float().mean())
    n_ragged = 100_003                       # not a multiple of the tile
    sub = {k: params[k] for k in ("non_rigid_mlp", "cnl_mlp")}
    alpha = 4.3
    results = {}
    for name, dt, skip_nr in K1_VARIANTS:
        plan = fused_mlp.Plan(
            nr_depth=net.mlp_plans[0].nr_depth,
            nr_skips=tuple(net.mlp_plans[0].nr_skips),
            nr_width=net.mlp_plans[0].nr_width,
            nr_multires=net.mlp_plans[0].nr_multires,
            cnl_depth=net.mlp_plans[0].cnl_depth, cnl_skips=(4,),
            cnl_width=net.mlp_plans[0].cnl_width,
            cnl_multires=net.mlp_plans[0].cnl_multires, skip_nr=skip_nr,
            compute_dtype=dt)
        out = fused_mlp.query_points_fused(plan, sub, x, alpha, cc, live)
        torch.cuda.synchronize()
        ref = fused_mlp.query_points_plain(plan, sub, x, alpha, cc, live)
        err = float((out - ref).abs().max())
        # ragged N, every tile live
        xr = x[:n_ragged].contiguous()
        out_r = fused_mlp.query_points_fused(plan, sub, xr, alpha, cc, None)
        ref_r = fused_mlp.query_points_plain(plan, sub, xr, alpha, cc, None)
        torch.cuda.synchronize()
        err_r = float((out_r - ref_r).abs().max())
        finite = bool(torch.isfinite(out).all() and torch.isfinite(out_r).all())
        # context for the bf16 tolerance: how far the plain bf16 version is
        # from the plain f32 one on the same inputs
        plain_vs_f32 = None
        if dt == torch.bfloat16:
            plan.compute_dtype = torch.float32
            ref32 = fused_mlp.query_points_plain(plan, sub, x, alpha, cc, live)
            plan.compute_dtype = dt
            plain_vs_f32 = float((ref - ref32).abs().max())
            del ref32
        del ref, out_r, ref_r
        # timed as the serving path calls it: operands prepared once a frame
        kw = fused_mlp.make_kernel_weights(plan, sub["non_rigid_mlp"],
                                           sub["cnl_mlp"], cc)
        def k1():
            fused_mlp.query_points_fused(plan, sub, x, alpha, cc, live,
                                         kernel_weights=kw)
        ms = time_ms(k1, warm=1, iters=5)
        device_ms = kernel_device_ms(k1, K1_KEY[dt], iters=5)
        plain_ms = time_ms(lambda: fused_mlp.query_points_plain(
            plan, sub, x, alpha, cc, live), warm=1, iters=2)
        n_live = int(live.sum()) * fused_mlp.TILE
        chain_ms = matmul_chain_ms(plan, n_live, dev)
        flops = n_live * plan.flops_per_sample()
        w_bytes = sum(t.numel() * t.element_size()
                      for net_w in kw.values()
                      for t in (net_w["w_h"] + net_w["w_e"] + net_w["b"]
                                + [net_w["w_out"], net_w["b_out"]])
                      if t is not None)
        nbytes = n_live * 12 + N * 16 + n_tiles * 4 + w_bytes
        peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_F32_FLOPS
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        results[name] = {
            "name": f"fused_mlp_forward[{name}]", "route": "cuda",
            "source": "humannerf_tpu_torch/csrc/fused_mlp.cu",
            "replaces": "humannerf_tpu/ops/pallas_mlp.py:505",
            "launches": 0, "max_abs_err": max(err, err_r),
            "tolerance": K1_TOL[dt], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "device_ms": device_ms,
            "matmul_chain_ms": chain_ms, "n": N, "live_share": live_frac,
            "tflops": flops / (device_ms * 1e-3) / 1e12,
            "bound_share": max(t_ops, t_bytes) / device_ms}
        emit("kernels", **results[name], err_ragged=err_r, finite=finite,
             plain_vs_f32=plain_vs_f32)
        if not finite:
            fail(f"K1[{name}] produced non-finite values")
        if not max(err, err_r) <= K1_TOL[dt]:
            fail(f"K1[{name}] disagrees with its plain version: "
                 f"{max(err, err_r)} > {K1_TOL[dt]}")

    # K6 at the serving path's block shape
    R = n_rays
    raw = (torch.randn((R, S, 4), generator=gen) * 2.0).to(dev)
    fg = torch.rand((R, S, 1), generator=gen)
    fg = torch.where(fg > 0.6, fg, torch.zeros_like(fg)).to(dev)
    near = torch.full((R,), 0.7)
    z = (near[:, None] + torch.linspace(0, 1, S)[None] * 0.6).to(dev)
    rays_d = (torch.randn((R, 3), generator=gen) + 2.0).to(dev)
    bg = torch.tensor([10.0, 60.0, 200.0], device=dev)
    out = composite.composite(raw, fg, z, rays_d, bg)
    torch.cuda.synchronize()
    ref = raw2outputs(raw, fg, z, rays_d, bg)
    err = max(float((out[k] - ref[k]).abs().max())
              for k in ("rgb", "alpha", "depth"))
    finite = all(bool(torch.isfinite(out[k]).all()) for k in out)
    ms = time_ms(lambda: composite.composite(raw, fg, z, rays_d, bg), 2, 10)
    device_ms = kernel_device_ms(
        lambda: composite.composite(raw, fg, z, rays_d, bg),
        "composite_kernel", iters=10)
    plain_ms = time_ms(lambda: raw2outputs(raw, fg, z, rays_d, bg), 2, 10)
    nbytes = R * S * 24 + R * 12 + R * 20
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = R * S * 40 / PEAK_F32_FLOPS * 1e3
    results["composite"] = {
        "name": "composite_forward", "route": "cuda",
        "source": "humannerf_tpu_torch/csrc/composite.cu",
        "replaces": "humannerf_tpu/ops/pallas_composite.py:78",
        "launches": 0, "max_abs_err": err, "tolerance": K6_TOL, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "device_ms": device_ms,
        "bound_share": max(t_ops, t_bytes) / device_ms, "rays": R,
        "samples": S, "gbytes_per_s": nbytes / (device_ms * 1e-3) / 1e9}
    emit("kernels", **results["composite"], finite=finite)
    if not finite:
        fail("K6 produced non-finite values")
    if not err <= K6_TOL:
        fail(f"K6 disagrees with its plain version: {err} > {K6_TOL}")
    return results


# ---------------------------------------------------------------------------
# K5, the analytic-band route's gather + trilerp + warp
# ---------------------------------------------------------------------------

# kernel vs plain version, per value |kernel - plain| <= K5_TOL (1 + |plain|):
# the same float32 products of the same rows, summed in another order (the
# kernel per corner with fma, then across the 8 corners by shuffles)
K5_TOL = 1e-5
# operations of one valid live sample: per corner 3 weight factors (4 each), 2
# weight products, 3 weighted coordinates, 4 outputs of 4 multiply-adds;
# then 3 shuffle-adds of 4 values, a reciprocal and 3 products
K5_OPS_PER_SAMPLE = 8 * (3 * 4 + 2 + 3 + 4 * 4 * 2) + 3 * 4 + 4


def analytic_block(cfg, params, item, dev):
    """K5's operands on the analytic-band route for the frame's first
    block of CHUNK rays: (packed volume, points (N, 3) z-major in sorted ray
    order, obs_min, obs_max, band liveness (N,))."""
    net = HumanNeRF(cfg)
    frame = {k: torch.as_tensor(np.asarray(item[k], np.float32)).to(dev)
             for k in FRAME_KEYS if k in item}
    rays = {k: torch.as_tensor(np.asarray(item[k][:CHUNK], np.float32)
                               ).to(dev) for k in RAY_KEYS}
    with torch.no_grad():
        ctx = net.prepare_frame(params, frame, cfg.eval_iter)
        z = sample_along_rays(rays["near"], rays["far"], net.n_samples)
        pts, live, _, _ = net.analytic_samples(
            ctx, rays["rays_o"], rays["rays_d"], rays["near"], rays["far"],
            z)
    return ctx["packed_volume"], pts, ctx["obs_min"], ctx["obs_max"], live


def k5_bytes(U8, pts, lo, hi, live):
    """The bytes K5 must move for these inputs -> (bytes, valid live
    samples, distinct rows read). Every sample reads its liveness (1 B) and
    writes x_skel and fg (16 B); a live sample also reads its point (12 B);
    the valid live samples read the distinct base rows under them, each
    once, 8 corners x 13 used channels. Validity as the kernel computes it."""
    G = U8.shape[0]
    f = (pts - lo) * trilerp._grid_scale(lo, hi, G)
    valid = ((f >= 0) & (f <= G - 1)).all(dim=1) & live
    i0 = torch.floor(f).clamp(0, G - 2).long()
    flat = (i0[:, 2] * G + i0[:, 1]) * G + i0[:, 0]
    n_rows = int(torch.unique(flat[valid]).numel())
    nbytes = (pts.shape[0] * (1 + 16) + int(live.sum()) * 12
              + n_rows * 8 * 13 * U8.element_size())
    return nbytes, int(valid.sum()), n_rows


def k5_against_plain(U8, pts, lo, hi, live):
    """-> (max abs error, within K5_TOL, finite, dead samples exactly 0)."""
    x, fg = trilerp.sample_packed_volume_t(U8, pts, lo, hi, live)
    torch.cuda.synchronize()
    xp, fgp = trilerp.sample_packed_volume_t_plain(U8, pts, lo, hi, live)
    out, ref = torch.cat([x, fg[:, None]], 1), torch.cat([xp, fgp[:, None]], 1)
    diff = (out - ref).abs()
    dead = fgp == 0
    return (float(diff.max()) if diff.numel() else 0.0,
            bool((diff <= K5_TOL * (1.0 + ref.abs())).all()),
            bool(torch.isfinite(out).all()),
            float(out[dead].abs().sum()) == 0.0)


def phase_kernels_trilerp(cfg, params, item) -> dict:
    """K5 against its plain version on the first block of the synthetic
    frame in the route's layout (8 192 rays x 128 samples), in bf16 (the
    frame's own volume) and f32 (the same volume cast up), each also at a
    ragged N, with every sample dead and with points out of range."""
    dev = runtime.setup()
    U8, pts, lo, hi, live = analytic_block(cfg, params, item, dev)
    N = pts.shape[0]
    live_share = float(live.float().mean())
    # points scattered to twice the distance from the box centre: about
    # seven in eight leave the obs box
    centre = (lo + hi) * 0.5
    far_pts = (centre + 2.0 * (pts - centre)).contiguous()
    n_ragged = 100_003
    results = {}
    for short, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        U = U8.to(dt)
        checks = {
            "frame": k5_against_plain(U, pts, lo, hi, live),
            "ragged": k5_against_plain(U, pts[:n_ragged].contiguous(), lo,
                                       hi, live[:n_ragged].contiguous()),
            "all_dead": k5_against_plain(U, pts, lo, hi,
                                         torch.zeros_like(live)),
            "out_of_range": k5_against_plain(U, far_pts, lo, hi, None)}
        def k5():
            return trilerp.sample_packed_volume_t(U, pts, lo, hi, live)
        # the kernel alone; a run of calls is bound by the wrapper's host
        # work (checks, the box's scale, two allocations, the ctypes call)
        ms = kernel_device_ms(k5, "trilerp_kernel", iters=20)
        wrapper_ms = time_ms(k5, warm=2, iters=20)
        plain_ms = time_ms(lambda: trilerp.sample_packed_volume_t_plain(
            U, pts, lo, hi, live), warm=1, iters=3)
        nbytes, n_valid, n_rows = k5_bytes(U, pts, lo, hi, live)
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = n_valid * K5_OPS_PER_SAMPLE / PEAK_F32_FLOPS * 1e3
        err = max(c[0] for c in checks.values())
        results[f"trilerp:{short}"] = {
            "name": f"trilerp_forward[{short}]", "route": "cuda",
            "source": "humannerf_tpu_torch/csrc/trilerp.cu",
            "replaces": "humannerf_tpu/ops/pallas_trilerp.py:117",
            "launches": 0, "max_abs_err": err, "tolerance": K5_TOL,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "n": N, "grid": U.shape[0],
            "live_share": live_share, "valid_samples": n_valid,
            "rows_read": n_rows, "bytes": nbytes, "wrapper_ms": wrapper_ms,
            "gbytes_per_s": nbytes / (ms * 1e-3) / 1e9}
        emit("kernels", **results[f"trilerp:{short}"],
             checks={k: {"max_abs_err": c[0], "within_tolerance": c[1],
                         "finite": c[2], "dead_exactly_zero": c[3]}
                     for k, c in checks.items()})
        for k, (e, ok, finite, zero) in checks.items():
            if not (ok and finite and zero):
                fail(f"K5[{short}] {k}: max abs error {e} (tolerance "
                     f"{K5_TOL} relative), finite {finite}, dead samples "
                     f"exactly 0: {zero}")
    return results


# ---------------------------------------------------------------------------
# the backward kernels K2, K3, K4 against their plain versions
# ---------------------------------------------------------------------------

# Relative L2 error per gradient tensor, kernel vs autograd through the plain
# version on the same inputs.
# float32: both sum the same f32 products in another order (the kernels with
# atomics, whose order changes from run to run). K3 and K4 read ~1e-6; K2 reads
# 1e-6 without the non-rigid net and up to 3e-3 with it (the canonical
# embedding's top frequency, 2^9, amplifies the last bits of the offset).
# bfloat16, K3 and K4: the kernels differentiate the same rounded values as
# the plain version and differ from it in where the cotangent is rounded;
# they read ~6e-3.
# bfloat16, K2: the plain version multiplies bf16-rounded operands in float32
# with cuBLAS, the kernel on the tensor cores in another order, so the two
# round many activations and cotangents differently; each is 0.1-0.3 away from
# the float32 gradient per tensor, and about as far from the other. A direct
# limit that wide would prove little, so K2 in bf16 is held to the plain
# float32 gradients instead, per tensor: the kernel may be at most
# ACCURACY_RATIO times as far from them as the plain bf16 version is, and must
# point the same way (cosine >= ACCURACY_COS; a gradient of zeros reads 0).
# The kernel-vs-plain-bf16 distance is printed beside them.
K2_F32_TOL = 1e-2
K34_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ACCURACY_RATIO = 1.5
ACCURACY_COS = 0.5
RATIO_FLOOR = 1e-2      # a plain version closer than this counts as this far


def cosine(a, b) -> float:
    a, b = a.detach().float().flatten(), b.detach().float().flatten()
    return float(torch.dot(a, b) / (a.norm() * b.norm()).clamp_min(1e-30))


def accuracy_vs_f32(gk: dict, gp: dict, g32: dict,
                    limit: float = ACCURACY_RATIO) -> dict:
    """Per tensor: how far the kernels' bf16 gradients are from the plain
    float32 ones (relative L2), how far the plain bf16 ones are, the ratio
    of the two and the kernels' cosine with the float32 gradient. -> the
    worst tensor by ratio, the extremes, every tensor's row, and under
    "bad" every tensor over `limit` or under ACCURACY_COS."""
    rows = {}
    for k in g32:
        if float(g32[k].abs().max()) == 0:
            continue
        ek, ep = rel_l2(gk[k], g32[k]), rel_l2(gp[k], g32[k])
        rows[k] = (ek, ep, ek / max(ep, RATIO_FLOOR), cosine(gk[k], g32[k]))
    worst = max(rows, key=lambda k: rows[k][2])
    bad = [f"{k}: {r[0]:.4g} from the float32 gradient (cosine {r[3]:.3g}), "
           f"the plain bf16 version {r[1]:.4g}" for k, r in rows.items()
           if not (r[2] <= limit and r[3] >= ACCURACY_COS)]
    return {"worst": worst, "kernel_vs_f32": rows[worst][0],
            "plain_vs_f32": rows[worst][1], "ratio": rows[worst][2],
            "max_kernel_vs_f32": max(r[0] for r in rows.values()),
            "max_plain_vs_f32": max(r[1] for r in rows.values()),
            "min_cosine": min(r[3] for r in rows.values()),
            "limit_ratio": limit, "limit_cosine": ACCURACY_COS,
            "by_tensor": {k: [round(v, 5) for v in r]
                          for k, r in sorted(rows.items())},
            "bad": bad}


def train_item(cfg, seed: int) -> dict:
    """A training batch shaped like the dataset's: TRAIN_RAYS rays in
    N_PATCHES patches, seeded smooth targets."""
    item = synthetic_item(cfg, TRAIN_RAYS, seed)
    rng = np.random.RandomState(seed + 100)
    item["patch_ray_idx"] = np.arange(TRAIN_RAYS, dtype=np.int32).reshape(
        N_PATCHES, PATCH, PATCH)
    base = rng.uniform(0.2, 0.8, (N_PATCHES, 1, 1, 3))
    ramp = np.linspace(-0.15, 0.15, PATCH)[None, :, None, None]
    item["target_patches"] = np.clip(
        base + ramp + rng.normal(0, 0.02, (N_PATCHES, PATCH, PATCH, 3)),
        0, 1).astype(np.float32)
    return item


def training_shapes(net: HumanNeRF, params: dict, item: dict) -> dict:
    """The tensors a training step hands to K2, K3 and K4 for this frame:
    what prepare_frame and render_block compute up to each kernel."""
    dev = net.device
    cfg = net.cfg
    S = net.n_samples
    with torch.no_grad():
        frame = {k: torch.as_tensor(np.asarray(item[k], np.float32)).to(dev)
                 for k in FRAME_KEYS if k in item}
        rays = {k: torch.as_tensor(np.asarray(item[k], np.float32)).to(dev)
                for k in RAY_KEYS}
        ctx = net.prepare_frame(params, frame, cfg.eval_iter, train=True)
        R = rays["rays_o"].shape[0]
        z = sample_along_rays(rays["near"], rays["far"], S)
        pts = (rays["rays_o"][:, None] + rays["rays_d"][:, None]
               * z[..., None]).reshape(-1, 3).contiguous()
        from humannerf_tpu_torch.ops import liveness as lv
        t0, t1 = lv.ray_band_intervals(
            rays["rays_o"], rays["rays_d"], rays["near"], rays["far"],
            ctx["motion_scale_Rs"], ctx["motion_Ts"],
            ctx["cnl_bbox_min_xyz"], ctx["cnl_bbox_scale_xyz"],
            ctx["band_dims"], ctx["band_sup_lo"], ctx["band_sup_hi"],
            obs_step=ctx["band_obs_step"])
        live_band = lv.sample_live_mask(z, t0, t1).reshape(-1)
        U = ctx["scatter_U"]
        x_skel, fg = fused_warp.sample_packed_volume(
            fused_warp.build_packed_volume(U), pts, ctx["obs_min"],
            ctx["obs_max"], live=live_band)
        fg_rs = fg.reshape(R, S)
        order, _ = fused_mlp.ray_sort_order(fg_rs, 0.0)
        xq = x_skel.reshape(R, S, 3)[order].transpose(0, 1).reshape(-1, 3)
        fgq = fg_rs[order].t().reshape(-1)
        from humannerf_tpu_torch.models import mweight
        mw = mweight.decode_mweight_volume(
            params["mweight_vol_decoder"], frame["motion_weights_priors"],
            dtype=net.compute_dtype)[:-1].contiguous()
    return {"x": xq.contiguous(), "fg": fgq,
            "live": fused_mlp.tile_liveness(fgq, 0.0),
            "cc": ctx["condition_code"], "U": U, "pts": pts,
            "live_band": live_band, "obs_min": ctx["obs_min"],
            "obs_max": ctx["obs_max"], "vols": mw,
            "Rs": ctx["motion_scale_Rs"], "Ts": ctx["motion_Ts"],
            "cnl_min": ctx["cnl_bbox_min_xyz"],
            "cnl_scale": ctx["cnl_bbox_scale_xyz"]}


def backward_ms(make_losses, warm: int, iters: int) -> float:
    """Device time of `.backward()` alone, summed over the (output,
    cotangent) pairs `make_losses` yields: a fresh forward before each."""
    total = 0.0
    for i in range(warm + iters):
        for out, cot in make_losses():
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out.backward(cot)
            end.record()
            torch.cuda.synchronize()
            if i >= warm:
                total += start.elapsed_time(end)
    return total / iters


# name, compute type, without the non-rigid net, tile liveness (the training
# frame's / N = 100 003 all live / N random points, all live), non-rigid
# output layer (mm-sized offsets as the `train` phase trains with / as initialised, 1e-5),
# whether the training phases launch this variant. The other two are
# measurements: they get a line of their own and stay out of the last list.
K2_VARIANTS = (("bf16", torch.bfloat16, False, "frame", "mm", True),
               ("f32", torch.float32, False, "frame", "mm", True),
               ("bf16,skip_nr", torch.bfloat16, True, "frame", "mm", True),
               ("f32,skip_nr", torch.float32, True, "ragged", "mm", True),
               ("bf16,all_live", torch.bfloat16, False, "all", "mm", False),
               ("bf16,initial_offsets", torch.bfloat16, False, "frame",
                "initial", False))
PLAIN_CHUNK = 128 * 1024    # samples per call of the plain MLP's backward


def plan_like(net: HumanNeRF, dt, skip_nr: bool) -> fused_mlp.Plan:
    p0 = net.mlp_plans[0]
    return fused_mlp.Plan(
        nr_depth=p0.nr_depth, nr_skips=tuple(p0.nr_skips),
        nr_width=p0.nr_width, nr_multires=p0.nr_multires,
        cnl_depth=p0.cnl_depth, cnl_skips=(4,), cnl_width=p0.cnl_width,
        cnl_multires=p0.cnl_multires, skip_nr=skip_nr, compute_dtype=dt)


def plain_chunks(plan, p, x, g, alpha, cc, live):
    """The plain MLP over x in chunks of samples, as (output, cotangent)
    pairs: its activations at full N would take tens of GB, and gradients
    add up over samples."""
    n = x.shape[0]
    for s0 in range(0, n, PLAIN_CHUNK):
        xs = x[s0:s0 + PLAIN_CHUNK]
        lv_ = None if live is None else \
            live[s0 // fused_mlp.TILE:
                 -(-(s0 + xs.shape[0]) // fused_mlp.TILE)]
        yield (fused_mlp.query_points_plain(plan, p, xs.contiguous(), alpha,
                                            cc, lv_), g[s0:s0 + PLAIN_CHUNK])


def mlp_grads(kernel: bool, plan, sub, x, g, alpha, cc, live) -> dict:
    """dx, the condition code's gradient and every dW / db of one backward
    through the fused kernels or through the plain version."""
    p = leafify(sub)
    xl = x.clone().requires_grad_(True)
    ccl = cc.clone().requires_grad_(True)
    if kernel:
        fused_mlp.query_points_fused(plan, p, xl, alpha, ccl,
                                     live).backward(g)
    else:
        for out, cot in plain_chunks(plan, p, xl, g, alpha, ccl, live):
            out.backward(cot)
    gr = flat_grads(p)
    if ccl.grad is not None:
        gr["condition_code"] = ccl.grad
    gr["dx"] = xl.grad
    return gr


def k4_adds(flat, valid, d_acc):
    """float4 atomics K4 makes on these inputs, with and without merging
    runs (csrc/scatter.cu): a warp holds 8 consecutive samples, and a
    channel quad makes one set of 8 corner adds for each run of them with a
    non-zero cotangent, validity and one base voxel, against one set per
    such sample. -> (merged, unmerged)."""
    group = 8
    n = flat.shape[0]
    work = valid[:, None] & (d_acc.reshape(n, 4, 4) != 0).any(dim=2)
    member = torch.zeros_like(work)
    member[1:] = work[1:] & work[:-1] & (flat[1:] == flat[:-1])[:, None]
    member[::group] = False
    total = int(work.sum())
    return 8 * (total - int(member.sum())), 8 * total


def k3_library(shapes: dict, g3, G: int, d_vols_kernel):
    """K3's yardstick: grid_sample (bilinear, zeros, align_corners=True, the
    resample's semantics) of every bone at its warped grid, differentiated
    by one backward call, grid_sampler_3d_backward, which yields d(vols) and
    d(grid); dA and dT would need one more contraction of d(grid) with the
    grid. Its operands are prepared outside the timing, the cotangent in
    the (K, G^3) layout it wants. Float32. -> (device ms of the backward,
    relative L2 of its d(vols) from the kernel's)."""
    import torch.nn.functional as F
    vols = shapes["vols"]
    K = vols.shape[0]
    with torch.no_grad():
        grid = fused_warp.make_obs_grid(shapes["obs_min"], shapes["obs_max"],
                                        G)
        pos = torch.matmul(grid[None], shapes["Rs"].transpose(1, 2)) \
            + shapes["Ts"][:, None, :]
        coords = ((pos - shapes["cnl_min"]) * shapes["cnl_scale"] - 1.0) \
            .reshape(K, 1, 1, -1, 3).contiguous()
        cot = g3.t().contiguous().reshape(K, 1, 1, 1, -1)

    def make():
        v = vols.detach().clone().requires_grad_(True)
        c = coords.clone().requires_grad_(True)
        out = F.grid_sample(v[:, None], c, mode="bilinear",
                            padding_mode="zeros", align_corners=True)
        return out, cot, [v, c]
    ms, _ = node_device_ms(make, iters=5)
    out, cot_, leaves = make()
    d_vols, _ = torch.autograd.grad(out, leaves, cot_)
    return ms, rel_l2(d_vols, d_vols_kernel)


def phase_kernels_backward(net: HumanNeRF, params: dict, params_init: dict,
                           shapes: dict) -> dict:
    """K2, K3 and K4 against their plain versions at the training step's
    shapes. Every variant is run and printed before the phase fails, so that
    one run shows all disagreements."""
    dev = net.device
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    results, bad = {}, []
    alpha = 4.3
    cc = shapes["cc"]

    # ---- K2
    N = shapes["x"].shape[0]
    g_full = (torch.randn((N, 4), generator=gen) * 0.1).to(dev)
    x_spread = (torch.randn((N, 3), generator=gen) * 0.5).to(dev)
    for name, dt, skip_nr, mode, offsets, on_path in K2_VARIANTS:
        plan = plan_like(net, dt, skip_nr)
        sub = {k: (params if offsets == "mm" else params_init)[k]
               for k in ("non_rigid_mlp", "cnl_mlp")}
        n = 100_003 if mode == "ragged" else N
        # the frame's points; with every tile live, points spread over the
        # box: the frame's dead samples all sit at x = 0
        x = x_spread if mode == "all" else shapes["x"][:n].contiguous()
        g = g_full[:n].contiguous()
        live = None if mode in ("ragged", "all") else shapes["live"]
        live_share = 1.0 if live is None else float(live.float().mean())

        before = fused_mlp.bwd_launches
        gk = mlp_grads(True, plan, sub, x, g, alpha, cc, live)
        torch.cuda.synchronize()
        if fused_mlp.bwd_launches != before + 1:
            fail(f"K2[{name}]: the backward kernel was not launched")
        gp = mlp_grads(False, plan, sub, x, g, alpha, cc, live)
        if skip_nr:
            gk = {k: v for k, v in gk.items() if k in gp}
        if set(gk) != set(gp):
            fail(f"K2[{name}]: gradient sets differ: "
                 f"{sorted(set(gk) ^ set(gp))}")
        errs = {k: rel_l2(gk[k], gp[k]) for k in gp
                if float(gp[k].abs().max()) > 0}
        finite = all(bool(torch.isfinite(v).all()) for v in gk.values())
        worst = max(errs, key=errs.get)
        dx_abs = float((gk["dx"] - gp["dx"]).abs().max())
        accuracy = None
        if dt == torch.bfloat16:
            accuracy = accuracy_vs_f32(gk, gp, mlp_grads(
                False, plan_like(net, torch.float32, skip_nr), sub, x, g,
                alpha, cc, live))
            bad += [f"K2[{name}]: {b}" for b in accuracy.pop("bad")]
        elif not errs[worst] <= K2_F32_TOL:
            bad.append(f"K2[{name}]: gradient {worst} is {errs[worst]} "
                       f"(relative L2) from the plain version's, limit "
                       f"{K2_F32_TOL}")
        del gk, gp
        # the kernel alone, operands prepared as the autograd function does
        ops = fused_mlp.kernel_operands(
            plan, sub["non_rigid_mlp"], sub["cnl_mlp"], cc)
        nets = fused_mlp.pack_kernel_weights(plan, ops, backward=True)
        def k2():
            fused_mlp.launch_backward(plan, x, g, alpha, live, nets)
        ms = time_ms(k2, warm=1, iters=3)
        device_ms = kernel_device_ms(k2, K2_KEY[dt], iters=3)
        # the plain backward over every chunk of the same n samples, summed
        p = leafify(sub)
        plain_ms = backward_ms(
            lambda: plain_chunks(plan, p, x, g, alpha, cc, live), 1, 2)
        del p
        n_live = n if live is None else int(live.sum()) * fused_mlp.TILE
        flops = 3 * n_live * plan.flops_per_sample()
        w_bytes = sum(t.numel() * (t.element_size() + 4)
                      for nw in nets.values()
                      for t in (nw["w_h"] + nw["w_e"] + nw["b"]
                                + [nw["w_out"], nw["b_out"]])
                      if t is not None)
        nbytes = n_live * 28 + n * 12 + w_bytes
        peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_F32_FLOPS
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        res = {
            "name": f"fused_mlp_backward[{name}]", "route": "cuda",
            "source": "humannerf_tpu_torch/csrc/fused_mlp_bwd.cu",
            "replaces": "humannerf_tpu/ops/pallas_mlp.py:549",
            "launches": 0, "max_abs_err": dx_abs,
            "max_rel_l2_err": errs[worst], "worst": worst,
            "tolerance": K2_F32_TOL if dt == torch.float32 else None,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "device_ms": device_ms, "n": n,
            "live_share": live_share,
            "tflops": flops / (device_ms * 1e-3) / 1e12,
            "bound_share": max(t_ops, t_bytes) / device_ms}
        emit("kernels", **res, finite=finite, accuracy=accuracy,
             rel_l2={k: round(v, 6) for k, v in sorted(errs.items())})
        if not finite:
            fail(f"K2[{name}] produced non-finite gradients")
        if on_path:
            results[f"k2:{name}"] = res

    # ---- K3 and K4, in both compute types
    G = net.cfg.warp.grid_size
    K = shapes["vols"].shape[0]
    boxes = (shapes["cnl_min"], shapes["cnl_scale"], shapes["obs_min"],
             shapes["obs_max"])
    # cotangent of the resampled weights as the step produces it: non-zero
    # for every bone at the voxels the samples touch
    touched = (shapes["U"][..., 12].float().reshape(-1) > 0)
    g3 = (torch.randn((G ** 3, K), generator=gen)).to(dev) \
        * touched[:, None].float()
    Nk = shapes["pts"].shape[0]
    fg_mask = None
    for dt_name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        tol = K34_TOL[dt]

        def k3(fn):
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (shapes["vols"], shapes["Rs"], shapes["Ts"])]
            return fn(*leaves, *boxes, G, dt), g3, leaves

        def k3_grads(fn):
            out, cot, leaves = k3(fn)
            out.backward(cot)
            return dict(zip(("d_vols", "dA", "dT"),
                            (t.grad for t in leaves)))
        before = fused_warp.resample_launches
        gk = k3_grads(fused_warp.resample_all_bones)
        torch.cuda.synchronize()
        if fused_warp.resample_launches != before + 1:
            fail(f"K3[{dt_name}]: the kernel was not launched")
        gp = k3_grads(fused_warp.resample_all_bones_plain)
        errs = {k: rel_l2(gk[k], gp[k]) for k in gp}
        finite = all(bool(torch.isfinite(v).all()) for v in gk.values())
        worst = max(errs, key=errs.get)
        def k3_wrapper():
            fused_warp.resample_backward(shapes["vols"], shapes["Rs"],
                                         shapes["Ts"], *boxes, G, dt, g3)
        ms = time_ms(k3_wrapper, warm=2, iters=10)
        device_ms = kernel_device_ms(k3_wrapper, "resample_bwd_kernel",
                                     iters=10)
        # the backward node as the training step runs it: the kernel and
        # every launch of the wrapper's glue
        node_ms, node_kernels = node_device_ms(
            lambda: k3(fused_warp.resample_all_bones), iters=5)
        plain_ms = backward_ms(
            lambda: [k3(fused_warp.resample_all_bones_plain)[:2]], 1, 3)
        library_ms, lib_err = None, None
        if dt == torch.float32:
            library_ms, lib_err = k3_library(shapes, g3, G, gk["d_vols"])
            if not lib_err <= 1e-4:
                bad.append(f"K3[{dt_name}]: d(vols) is {lib_err} from "
                           f"grid_sample's")
        live_pairs = int((g3 != 0).sum())
        nbytes = g3.numel() * 4 + 2 * shapes["vols"].numel() * 4 + K * 96
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = live_pairs * 120 / PEAK_F32_FLOPS * 1e3
        results[f"k3:{dt_name}"] = {
            "name": f"resample_backward[{dt_name}]", "route": "cuda",
            "source": "humannerf_tpu_torch/csrc/resample_bwd.cu",
            "replaces": "humannerf_tpu/ops/pallas_resample.py:591",
            "launches": 0,
            "max_abs_err": float((gk["d_vols"] - gp["d_vols"]).abs().max()),
            "max_rel_l2_err": errs[worst], "worst": worst,
            "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "device_ms": device_ms,
            "node_ms": node_ms,
            "bound_share": max(t_ops, t_bytes) / device_ms,
            "grid": G, "bones": K,
            "live_pair_share": live_pairs / g3.numel()}
        emit("kernels", **results[f"k3:{dt_name}"], finite=finite,
             rel_l2=errs, node_kernels=node_kernels,
             library="grid_sampler_3d_backward: d(vols) and d(grid); dA/dT "
                     "need one more contraction" if library_ms else None,
             vs_library_rel_l2=lib_err)
        if not finite or not errs[worst] <= tol:
            bad.append(f"K3[{dt_name}]: gradient {worst} is {errs[worst]} "
                       f"from the plain version's, limit {tol}")

        # K4
        U = shapes["U"].to(dt)
        with torch.no_grad():
            _, fg0 = fused_warp.sample_packed_volume(
                fused_warp.build_packed_volume(U), shapes["pts"],
                shapes["obs_min"], shapes["obs_max"], shapes["live_band"])
            fg_mask = (fg0 > 0).float()
        gx = torch.randn((Nk, 3), generator=gen).to(dev) * fg_mask
        gf = torch.randn((Nk, 1), generator=gen).to(dev) * fg_mask

        def k4(fn, with_pts):
            Ul = U.detach().clone().requires_grad_(True)
            pl_ = shapes["pts"].clone().requires_grad_(with_pts)
            if fn == "kernel":
                x_, f_ = fused_warp.sample_packed_grad(
                    Ul, pl_, shapes["obs_min"], shapes["obs_max"],
                    shapes["live_band"])
            else:
                x_, f_ = fused_warp.sample_packed_volume(
                    fused_warp.build_packed_volume(Ul), pl_,
                    shapes["obs_min"], shapes["obs_max"],
                    shapes["live_band"])
            return torch.cat([x_, f_], dim=1), torch.cat([gx, gf], dim=1), \
                Ul, pl_

        def k4_grads(fn):
            out, cot, Ul, pl_ = k4(fn, True)
            out.backward(cot)
            return {"dU": Ul.grad, "d_pts": pl_.grad}
        before = fused_warp.scatter_launches
        gk = k4_grads("kernel")
        torch.cuda.synchronize()
        if fused_warp.scatter_launches != before + 1:
            fail(f"K4[{dt_name}]: the kernel was not launched")
        if gk["dU"].dtype != dt:
            fail(f"K4[{dt_name}]: dU is {gk['dU'].dtype}, expected {dt}")
        gp = k4_grads("plain")
        errs = {k: rel_l2(gk[k], gp[k]) for k in gp}
        finite = all(bool(torch.isfinite(v).all()) for v in gk.values())
        worst = max(errs, key=errs.get)
        with torch.no_grad():
            acc, (flat, w3, valid, _) = fused_warp.packed_acc(
                fused_warp.build_packed_volume(U), shapes["pts"],
                shapes["obs_min"], shapes["obs_max"], shapes["live_band"])
            d_acc = torch.randn((Nk, 16), generator=gen).to(dev) \
                * (valid[:, None] & (fg_mask > 0)).float()
        def k4_wrapper():
            fused_warp.scatter_grad_volume(flat, w3, valid, d_acc, G)
        ms = time_ms(k4_wrapper, warm=2, iters=10)
        device_ms = kernel_device_ms(k4_wrapper, "scatter_kernel", iters=10)

        def k4_node():
            # as the training step calls it: points without a gradient
            Ul = U.detach().clone().requires_grad_(True)
            acc = fused_warp._PackedSampleAcc.apply(
                Ul, shapes["pts"], shapes["obs_min"], shapes["obs_max"],
                shapes["live_band"])
            return acc, d_acc, [Ul]
        node_ms, node_kernels = node_device_ms(k4_node, iters=5)
        plain_ms = backward_ms(lambda: [k4("plain", False)[:2]], 1, 3)
        # the one library call that computes the same dU: index_add_ of the
        # eight weighted corner rows into the unpacked volume
        with torch.no_grad():
            k8 = torch.arange(8, device=dev)
            off = ((k8 >> 2) * G + ((k8 >> 1) & 1)) * G + (k8 & 1)
            idx = (flat[:, None] + off[None, :]).reshape(-1)
            src = (fused_warp._corner_weights(w3)[:, :, None]
                   * d_acc[:, None, :]).reshape(-1, 16)
            dU_lib = torch.zeros((G ** 3, 16), device=dev)
            library_ms = time_ms(
                lambda: dU_lib.zero_().index_add_(0, idx, src), 1, 3)
            dU_k = fused_warp.scatter_grad_volume(flat, w3, valid, d_acc, G)
            lib_err = rel_l2(dU_k.reshape(-1, 16),
                             dU_lib.zero_().index_add_(0, idx, src))
            del idx, src
        nz = int((d_acc.abs().sum(dim=1) > 0).sum())
        adds, adds_unmerged = k4_adds(flat, valid, d_acc)
        # what the kernel must move: every validity byte; for a valid sample
        # its int64 id, three fractions and 16 cotangents; dU written once
        n_valid = int(valid.sum())
        nbytes = Nk * 1 + n_valid * (8 + 12 + 64) + G ** 3 * 64
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = nz * 8 * 13 * 3 / PEAK_F32_FLOPS * 1e3
        results[f"k4:{dt_name}"] = {
            "name": f"scatter_volume_backward[{dt_name}]", "route": "cuda",
            "source": "humannerf_tpu_torch/csrc/scatter.cu",
            "replaces": "humannerf_tpu/ops/pallas_scatter.py:167",
            "launches": 0,
            "max_abs_err": float((gk["dU"].float()
                                  - gp["dU"].float()).abs().max()),
            "max_rel_l2_err": errs[worst], "worst": worst,
            "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "device_ms": device_ms,
            "node_ms": node_ms,
            "bound_share": max(t_ops, t_bytes) / device_ms, "n": Nk,
            "grid": G, "nonzero_cotangent_share": nz / Nk,
            "valid_share": n_valid / Nk, "vector_adds": adds,
            "vector_adds_unmerged": adds_unmerged,
            "adds_saved_share": 1.0 - adds / max(adds_unmerged, 1),
            "vs_library_rel_l2": lib_err}
        emit("kernels", **results[f"k4:{dt_name}"], finite=finite,
             rel_l2=errs, node_kernels=node_kernels)
        if not finite or not errs[worst] <= tol:
            bad.append(f"K4[{dt_name}]: gradient {worst} is {errs[worst]} "
                       f"from the plain version's, limit {tol}")
        if not lib_err <= 1e-4:
            bad.append(f"K4[{dt_name}]: dU is {lib_err} from index_add_'s")
    if bad:
        fail("; ".join(bad))
    return results


def phase_profile(cfg, params, item, name="profile"):
    """Where one warm frame's time goes: wall time of prepare_frame and of
    the blocks (host clock around a synchronise), then the same frame under
    torch.profiler for device time by kernel and the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    net = HumanNeRF(cfg)
    renderer = EvalRenderer(net, chunk=min(cfg.chunk, CHUNK))
    renderer.render_frame(params, item, cfg.eval_iter)       # warm-up

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return (time.time() - t0) * 1e3, out
    dev = net.device
    frame = {k: torch.as_tensor(np.asarray(item[k], np.float32)).to(dev)
             for k in FRAME_KEYS if k in item}
    rays = {k: torch.as_tensor(np.asarray(item[k], np.float32)).to(dev)
            for k in RAY_KEYS}
    prepare_ms, ctx = wall_ms(
        lambda: net.prepare_frame(params, frame, cfg.eval_iter))
    n = rays["rays_o"].shape[0]
    blocks_ms, _ = wall_ms(lambda: [
        net.render_block(params, ctx,
                         {k: v[s:s + CHUNK] for k, v in rays.items()})
        for s in range(0, n, CHUNK)])
    frame_ms, _ = wall_ms(
        lambda: renderer.render_frame(params, item, cfg.eval_iter))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        renderer.render_frame(params, item, cfg.eval_iter)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    emit(name, frame_ms=frame_ms, prepare_frame_ms=prepare_ms,
         blocks_ms=blocks_ms, n_blocks=-(-n // CHUNK),
         device_busy_ms=busy_ms, device_busy_share=busy_ms / frame_ms,
         device_kernel_launches=sum(r[2] for r in rows),
         top=[{"name": k[:60], "ms": round(ms, 3), "calls": c}
              for k, ms, c in rows[:12]])
    if busy_ms <= 0:
        fail(f"{name}: the trace shows no device time")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

# The schedules are cut to nothing, as depth may be: the non-rigid net and the
# pose refiner take part from the first step with the full frequency band
# (by default both wait for thousands of steps, during which the non-rigid
# embedding is all zeros).
TRAIN_OPTS = ["train.log_interval", "1", "progress.dump_interval", "1000000",
              "train.save_checkpt_interval", "1000000", "save_all", "False",
              "resume", "False", "non_rigid_motion_mlp.kick_in_iter", "0",
              "non_rigid_motion_mlp.full_band_iter", "0",
              "pose_decoder.kick_in_iter", "0"]
# A parameter gradient of one whole step, kernels vs the plain versions,
# relative L2 per tensor. float32: limit by module. The canonical and
# non-rigid MLPs get their gradients from K2 directly (K2_F32_TOL's reasons).
# The weight-volume decoder and the pose refiner get theirs from K2's dx
# through K4 and K3, as sums over all samples and grid points in which most
# of the terms cancel: where K3 and K4 alone agree to 1e-6, a dx that is 1e-3
# off gives a pose-refiner gradient that is 1.4e-2 off. bfloat16: held to the
# plain float32 step as K2 alone is (`accuracy_vs_f32`), with a wider ratio:
# in a step the kernels' route differs from the plain one twice, in K1's
# forward values and in K2's backward, and the cancelling sums amplify both
# (the extra phase `step_accuracy` reads each apart). Every bf16 route's
# pose-refiner gradient is 0.5-0.9 from the float32 one at mm-sized offsets.
STEP_F32_TOL = {"cnl_mlp": 1e-2, "non_rigid_mlp": 2e-2,
                "mweight_vol_decoder": 5e-2, "pose_decoder": 5e-2}
STEP_ACCURACY_RATIO = 2.0
PLAIN_ROUTES = ["pallas.mlp", "False", "pallas.scatter", "False",
                "pallas.resample", "False"]


class RepeatLoader:
    """The loader interface Trainer.train needs, over a fixed list."""

    def __init__(self, items):
        self.items = items

    def endless(self):
        while True:
            yield from self.items


def reset_counts():
    fused_mlp.launches = fused_mlp.bwd_launches = 0
    fused_warp.resample_launches = fused_warp.scatter_launches = 0
    composite.launches = trilerp.launches = 0


def read_counts() -> dict:
    return {"fused_mlp": fused_mlp.launches,
            "fused_mlp_bwd": fused_mlp.bwd_launches,
            "resample_bwd": fused_warp.resample_launches,
            "scatter": fused_warp.scatter_launches,
            "composite": composite.launches,
            "trilerp": trilerp.launches}


def make_trainer(tmp, opts, params=None):
    cfg = make_cfg(opts=TRAIN_OPTS + opts, base_dir=tmp)
    trainer = Trainer(cfg, log=lambda *a: None)
    if params is not None:
        trainer.set_params(params)
    return trainer


def step_gradients(trainer, batch):
    """Loss and every parameter gradient of one step, no update."""
    trainer.optimizer.zero_grad(set_to_none=True)
    loss, _ = trainer._loss_fn(trainer.params, batch, trainer.gen,
                               trainer.iter)
    loss.backward()
    torch.cuda.synchronize()
    return float(loss.detach()), {k: v.clone() for k, v in
                         flat_grads(trainer.params).items()}


def run_training(tmp, opts, params, item, steps):
    """`steps` steps of Trainer.train on one repeated frame, launch counts
    set to 0 just before and read just after.
    -> (trainer, losses, ms per step, counts)."""
    trainer = make_trainer(tmp, opts, params)
    losses, ms = [], []
    step = trainer.train_step

    def timed(batch, noise=None):
        torch.cuda.synchronize()
        t0 = time.time()
        loss, terms = step(batch, noise)
        losses.append(float(loss))             # waits for the device
        ms.append((time.time() - t0) * 1e3)
        return loss, terms
    trainer.train_step = timed
    reset_counts()
    trainer.train(loader=RepeatLoader([item]), max_steps=steps)
    counts = read_counts()
    trainer.train_step = step
    return trainer, losses, ms, counts


def check_training(name, losses, counts, steps, falling):
    if len(losses) != steps or not np.isfinite(losses).all():
        fail(f"{name}: losses {losses}")
    if falling and not np.mean(losses[-3:]) < np.mean(losses[:3]):
        fail(f"{name}: the loss did not fall: {losses}")
    for k in ("fused_mlp", "fused_mlp_bwd", "resample_bwd", "scatter"):
        if counts[k] != steps:
            fail(f"{name}: {counts[k]} launches of {k} in {steps} steps, "
                 f"expected one a step")
    if counts["trilerp"]:
        fail(f"{name}: a training step launched the eval-only K5")


def compare_with_plain(tmp, name, opts, params, item, bf16: bool):
    """The first step's gradients through the kernels and through the plain
    versions (pallas.mlp / scatter / resample false), same parameters, same
    batch, no depth jitter; in bf16 also through the plain versions in
    float32. -> (readings, disagreements)."""
    opts = opts + ["train.perturb", "0.0"]
    tk = make_trainer(tmp, opts, params)
    batch = to_device_batch(item, tk.device)
    reset_counts()
    loss_k, gk = step_gradients(tk, batch)
    del tk
    before = read_counts()
    if any(before[k] != 1 for k in ("fused_mlp", "fused_mlp_bwd",
                                    "resample_bwd", "scatter")):
        fail(f"{name}: the step through the kernels launched {before}")
    loss_p, gp = step_gradients(
        make_trainer(tmp, opts + PLAIN_ROUTES, params), batch)
    if read_counts() != before:
        fail(f"{name}: the plain step launched a kernel")
    if set(gk) != set(gp):
        fail(f"{name}: gradient sets differ: {sorted(set(gk) ^ set(gp))}")
    errs = {k: rel_l2(gk[k], gp[k]) for k in gp
            if float(gp[k].abs().max()) > 0}
    by_module = {}
    for k, v in errs.items():
        m = k.split(".")[0]
        by_module[m] = max(by_module.get(m, 0.0), v)
    res = {"loss": loss_k, "loss_plain": loss_p, "n_gradients": len(errs),
           "max_rel_l2": max(errs.values()), "by_module": by_module}
    bad = []
    if not abs(loss_k - loss_p) <= 2e-2 * abs(loss_p):
        bad.append(f"{name}: loss {loss_k} vs {loss_p} through the plain "
                   f"versions")
    if bf16:
        _, g32 = step_gradients(make_trainer(
            tmp, opts + PLAIN_ROUTES + ["dtype", "float32"], params), batch)
        res["accuracy"] = accuracy_vs_f32(gk, gp, g32, STEP_ACCURACY_RATIO)
        bad += [f"{name}: {b}" for b in res["accuracy"].pop("bad")]
    else:
        res["tolerance"] = STEP_F32_TOL
        for k, v in errs.items():
            if not v <= STEP_F32_TOL[k.split(".")[0]]:
                bad.append(f"{name}: gradient {k} is {v} (relative L2) from "
                           f"the plain versions', limit "
                           f"{STEP_F32_TOL[k.split('.')[0]]}")
    res["rel_l2"] = {k: round(v, 5) for k, v in sorted(errs.items())}
    return res, bad


def phase_train(tmp, params, item, kernels):
    trainer, losses, ms, counts = run_training(tmp, [], params, item,
                                               TRAIN_STEPS)
    check_training("train", losses, counts, TRAIN_STEPS, falling=True)
    warm = sorted(ms[3:])
    # one step without the non-rigid net (tpose-style training)
    _, losses_i, ms_i, counts_i = run_training(
        tmp, ["ignore_non_rigid_motions", "True"], params, item, 2)
    check_training("train[ignore_non_rigid]", losses_i, counts_i, 2, False)
    vs, bad = compare_with_plain(tmp, "train", [], params, item, bf16=True)
    emit("train", dtype="bfloat16", steps=TRAIN_STEPS, rays=TRAIN_RAYS,
         samples=trainer.net.n_samples, losses=losses,
         ms_per_step_median=warm[len(warm) // 2], ms_per_step=ms,
         launches=counts, launches_per_step={k: v / TRAIN_STEPS
                                             for k, v in counts.items()},
         dead_tile_share=trainer.net.dead_tile_share(),
         ignore_non_rigid={"losses": losses_i, "ms_per_step": ms_i,
                           "launches": counts_i},
         first_step_vs_plain=vs)
    if bad:
        fail("; ".join(bad))
    for k, cnt in (("k2:", "fused_mlp_bwd"), ("k3:", "resample_bwd"),
                   ("k4:", "scatter")):
        if k + "bf16" in kernels:
            kernels[k + "bf16"]["launches"] = counts[cnt]
    if "k2:bf16,skip_nr" in kernels:
        kernels["k2:bf16,skip_nr"]["launches"] = counts_i["fused_mlp_bwd"]


def phase_train_f32(tmp, params, item, kernels):
    opts = ["dtype", "float32"]
    trainer, losses, ms, counts = run_training(tmp, opts, params, item, 3)
    check_training("train_f32", losses, counts, 3, falling=False)
    _, losses_i, ms_i, counts_i = run_training(
        tmp, opts + ["ignore_non_rigid_motions", "True"], params, item, 1)
    check_training("train_f32[ignore_non_rigid]", losses_i, counts_i, 1,
                   False)
    vs, bad = compare_with_plain(tmp, "train_f32", opts, params, item,
                                 bf16=False)
    emit("train_f32", dtype="float32", steps=3, losses=losses, ms_per_step=ms,
         launches=counts, ignore_non_rigid={"losses": losses_i,
                                            "ms_per_step": ms_i,
                                            "launches": counts_i},
         first_step_vs_plain=vs)
    if bad:
        fail("; ".join(bad))
    for k, cnt in (("k2:", "fused_mlp_bwd"), ("k3:", "resample_bwd"),
                   ("k4:", "scatter")):
        if k + "f32" in kernels:
            kernels[k + "f32"]["launches"] = counts[cnt]
    if "k2:f32,skip_nr" in kernels:
        kernels["k2:f32,skip_nr"]["launches"] = counts_i["fused_mlp_bwd"]


def optimizer_state(trainer) -> dict:
    """{parameter path: (exp_avg, exp_avg_sq, step, lr)} of a Trainer."""
    lr = {id(p): g["lr"] for g in trainer.optimizer.param_groups
          for p in g["params"]}
    out = {}
    for k, p in flat_leaves(trainer.params).items():
        st = trainer.optimizer.state.get(p)
        if st:
            out[k] = (st["exp_avg"], st["exp_avg_sq"], float(st["step"]),
                      lr[id(p)])
    return out


def phase_train_resume(tmp, params, item):
    """Two steps, a checkpoint, a fresh Trainer that resumes from it: its
    parameters, Adam moments, step counts and learning rates must equal the
    first Trainer's bit for bit. Then the third step against three steps in
    one run: equal up to what the atomics' summation order does."""
    opts = ["train.perturb", "0.0"]
    a, losses_a, _, _ = run_training(tmp + "/a", opts, params, item, 3)
    b, losses_b, _, _ = run_training(tmp + "/b", opts, params, item, 2)
    cfg_c = make_cfg(opts=TRAIN_OPTS + opts + ["resume", "True"],
                     base_dir=tmp + "/b")
    b.save("latest", b.iter - 1)     # the last finished step; resume adds 1
    c = Trainer(cfg_c, log=lambda *a: None)
    if c.iter != 3:
        fail(f"train_resume: resumed at iter {c.iter}, expected 3")
    pb, pc = flat_leaves(b.params), flat_leaves(c.params)
    sb, sc = optimizer_state(b), optimizer_state(c)
    if set(pb) != set(pc) or set(sb) != set(sc) or not sb:
        fail(f"train_resume: {len(sc)} optimizer states restored of "
             f"{len(sb)}, {len(pc)} parameters of {len(pb)}")
    unequal = [k for k in pb if not torch.equal(pb[k], pc[k])]
    unequal += [f"{k}.{field}" for k in sb for i, field in
                enumerate(("exp_avg", "exp_avg_sq"))
                if not torch.equal(sb[k][i], sc[k][i])]
    unequal += [f"{k}.step/lr" for k in sb if sb[k][2:] != sc[k][2:]]
    reset_counts()
    batch = to_device_batch(item, c.device)
    loss_c = float(c.train_step(batch)[0])
    pa = flat_leaves(a.params)
    lr = float(cfg_c.train.lr)
    with torch.no_grad():
        max_abs = max(float((pa[k] - pc[k]).abs().max()) for k in pa)
        mean_abs = float(np.mean([float((pa[k] - pc[k]).abs().mean())
                                  for k in pa]))
    emit("train_resume", losses_uninterrupted=losses_a,
         losses_before_resume=losses_b, loss_after_resume=loss_c,
         optimizer_states_restored=len(sc), restored_unequal=unequal[:8],
         steps_and_lrs=sorted({v[2:] for v in sc.values()}),
         param_max_abs_diff=max_abs, param_mean_abs_diff=mean_abs,
         tolerance_mean=0.1 * lr, tolerance_loss_rel=1e-2)
    if unequal:
        fail(f"train_resume: not restored bit for bit: {unequal[:8]}")
    # Adam's update is lr * m / (sqrt(v) + eps): the sums of the kernels'
    # atomics differ in their last bits from run to run, which can turn the
    # sign of an update whose gradient is near zero, so single entries of
    # two runs may be 2 lr apart after each step; on average they agree far
    # closer, and the loss does.
    if not abs(loss_c - losses_a[2]) <= 1e-2 * abs(losses_a[2]):
        fail(f"train_resume: loss {loss_c} after the resume, "
             f"{losses_a[2]} uninterrupted")
    if not mean_abs <= 0.1 * lr:
        fail(f"train_resume: parameters differ by {mean_abs} on average "
             f"from the uninterrupted run's")


QUERY_FUSED = fused_mlp.query_points_fused


def k1_forward_plain_backward(plan, params, x, alpha, cc, live=None):
    """K1's values with the plain version's gradient."""
    plain = fused_mlp.query_points_plain(plan, params, x, alpha, cc, live)
    with torch.no_grad():
        fused = QUERY_FUSED(plan, params, x, alpha, cc, live)
    return plain + (fused - plain).detach()


def plain_forward_k2_backward(plan, params, x, alpha, cc, live=None):
    """The plain version's values with K2's gradient."""
    fused = QUERY_FUSED(plan, params, x, alpha, cc, live)
    with torch.no_grad():
        plain = fused_mlp.query_points_plain(plan, params, x, alpha, cc, live)
    return fused + (plain - fused).detach()


def phase_step_accuracy(tmp, params, item):
    """Which kernel moves a bf16 step's gradients how far from the plain
    float32 step's: all plain, all kernels, each kernel alone, and the fused
    MLP's forward and backward kernels apart. Per route and module the
    largest relative L2 distance and the smallest cosine."""
    off = "False"
    plain_warp = ["pallas.scatter", off, "pallas.resample", off]
    routes = {
        "plain_f32": (PLAIN_ROUTES + ["dtype", "float32"], None),
        "plain_bf16": (PLAIN_ROUTES, None),
        "kernels": ([], None),
        "k1_k2_only": (plain_warp, None),
        "k3_only": (["pallas.mlp", off, "pallas.scatter", off], None),
        "k4_only": (["pallas.mlp", off, "pallas.resample", off], None),
        "k1_only": (plain_warp, k1_forward_plain_backward),
        "k2_only": (plain_warp, plain_forward_k2_backward)}
    grads = {}
    for name, (opts, query) in routes.items():
        trainer = make_trainer(tmp, opts + ["train.perturb", "0.0"], params)
        fused_mlp.query_points_fused = query or QUERY_FUSED
        _, grads[name] = step_gradients(
            trainer, to_device_batch(item, trainer.device))
        fused_mlp.query_points_fused = QUERY_FUSED
        del trainer
    ref = grads.pop("plain_f32")
    table = {}
    for name, g in grads.items():
        by_module = {}
        for k, t in g.items():
            if float(ref[k].abs().max()) == 0:
                continue
            m = by_module.setdefault(k.split(".")[0], [0.0, 1.0])
            m[0] = max(m[0], rel_l2(t, ref[k]))
            m[1] = min(m[1], cosine(t, ref[k]))
        table[name] = by_module
    emit("step_accuracy", reference="plain_f32",
         columns=["max_rel_l2", "min_cosine"], routes=table)


def phase_profile_train(tmp, params, item, opts=(), name="profile_train"):
    """Where one warm training step's time goes: the step under
    torch.profiler, device time by kernel and the device's busy share.
    opts: config overrides (["dtype", "float32"] for the f32 step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    trainer = make_trainer(tmp, list(opts), params)
    batch = to_device_batch(item, trainer.device)
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.time()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) * 1e3

    def wall(fn):
        torch.cuda.synchronize()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        return (time.time() - t) * 1e3, out
    trainer.optimizer.zero_grad(set_to_none=True)
    fwd_ms, (loss, _) = wall(lambda: trainer._loss_fn(
        trainer.params, batch, trainer.gen, trainer.iter))
    bwd_ms, _ = wall(loss.backward)
    opt_ms, _ = wall(trainer.optimizer.step)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(batch)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and "#" not in e.key]         # record_function markers
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    emit(name, step_ms=step_ms, forward_ms=fwd_ms,
         backward_ms=bwd_ms, optimizer_ms=opt_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / step_ms,
         device_kernel_launches=sum(r[2] for r in rows),
         top=[{"name": k[:60], "ms": round(ms, 3), "calls": c}
              for k, ms, c in rows[:16]],
         hand_written={key: sum(ms for k, ms, _ in rows if key in k)
                       for key in ("fused_mlp_bf16_kernel",
                                   "fused_mlp_kernel",
                                   "fused_mlp_bwd_bf16_kernel",
                                   "fused_mlp_bwd_kernel",
                                   "resample_bwd_kernel", "scatter_kernel")})
    if busy_ms <= 0:
        fail(f"{name}: the trace shows no device time")


def render_frames(cfg, params, items, device=None):
    """Render items through EvalRenderer with the launch counts set to 0
    just before and read just after. -> (outputs, seconds, counts, net)."""
    net = HumanNeRF(cfg, device=device)
    renderer = EvalRenderer(net, chunk=min(cfg.chunk, CHUNK))
    fused_mlp.launches = composite.launches = trilerp.launches = 0
    outs, secs = [], []
    for item in items:
        torch.cuda.synchronize()
        t0 = time.time()
        outs.append(renderer.render_frame(params, item, cfg.eval_iter))
        secs.append(time.time() - t0)      # render_frame ends in a host copy
    counts = {"fused_mlp": fused_mlp.launches, "composite": composite.launches,
              "trilerp": trilerp.launches}
    return outs, secs, counts, net


def plain_query(plan, params, x, alpha, cc, live=None, kernel_weights=None):
    return fused_mlp.query_points_plain(plan, params, x, alpha, cc, live)


def render_frames_plain(cfg, params, items):
    """render_frames with K1 and K5 swapped for their plain versions (the
    analytic-band route has no switch of its own for either)."""
    kernel_fns = fused_mlp.query_points_fused, trilerp.sample_packed_volume_t
    fused_mlp.query_points_fused = plain_query
    trilerp.sample_packed_volume_t = trilerp.sample_packed_volume_t_plain
    try:
        return render_frames(cfg, params, items)
    finally:
        fused_mlp.query_points_fused, trilerp.sample_packed_volume_t = \
            kernel_fns


# the analytic-band route's frame against the default route's (both through
# the kernels) and against the same route through the plain versions: the
# routes compute every sample the same way except the trilerp (K5 sums in
# another order than the legacy gather + multiply-and-sum), and in bf16 a
# last-bit difference of x_skel can flip an activation's rounding in K1.
# The bf16 limits are about 5x the readings on an H100 80GB HBM3 at 700 W
# (route 2.1e-4, plain 2.0e-3: the plain MLP rounds its activations
# differently from K1); float32 keeps the render tests' 1e-4.
ANALYTIC_TOL = {"bfloat16": {"route": 1e-3, "plain": 1e-2},
                "float32": {"route": 1e-4, "plain": 1e-4}}


def phase_render_analytic(params, items, base, kernels):
    n_blocks = -(-N_RAYS // CHUNK)
    for dtype, short, frames in (("bfloat16", "bf16", items),
                                 ("float32", "f32", items[:1])):
        opts = ["eval.metrics", "['psnr', 'ssim']", "dtype", dtype]
        cfg_a = make_cfg(opts=opts + ["pallas.analytic_bands", "True"])
        outs, secs, counts, net = render_frames(cfg_a, params, frames)
        check_outputs("render_analytic", outs, N_RAYS)
        if counts["trilerp"] != n_blocks * len(frames) \
                or counts["fused_mlp"] != n_blocks * len(frames):
            fail(f"render_analytic[{short}]: launches {counts}, expected "
                 f"{n_blocks} of K5 and of K1 a frame")
        if base is not None and dtype == "bfloat16":
            legacy = base[0]
        else:
            legacy = render_frames(make_cfg(opts=opts), params,
                                   frames[:1])[0][0]
        outs_p, secs_p, counts_p, _ = render_frames_plain(cfg_a, params,
                                                          frames[:1])
        if counts_p["trilerp"] or counts_p["fused_mlp"]:
            fail(f"render_analytic[{short}]: the plain render launched "
                 f"{counts_p}")
        d_route, d_plain = max_diff(outs[0], legacy), max_diff(outs[0],
                                                                outs_p[0])
        best = min(secs[1:]) if len(secs) > 1 else secs[0]
        emit("render_analytic", dtype=dtype, frames=len(frames),
             rays=N_RAYS, samples=cfg_a.N_samples,
             blocks_per_frame=n_blocks, seconds=secs,
             ray_samples_per_s=N_RAYS * cfg_a.N_samples / best,
             plain_seconds=secs_p, launches=counts,
             launches_per_frame={k: v / len(frames)
                                 for k, v in counts.items()},
             dead_tile_share=net.dead_tile_share(), vs_legacy_route=d_route,
             vs_plain=d_plain, tolerance=ANALYTIC_TOL[dtype])
        tol = ANALYTIC_TOL[dtype]
        if not (max(d_route.values()) <= tol["route"]
                and max(d_plain.values()) <= tol["plain"]):
            fail(f"render_analytic[{short}]: differs from the legacy route "
                 f"by {d_route} and from the plain versions by {d_plain}, "
                 f"tolerance {tol}")
        if f"trilerp:{short}" in kernels:
            kernels[f"trilerp:{short}"]["launches"] = counts["trilerp"]


def phase_cli_analytic(params):
    """The analytic-band route through the render CLI as a user runs it,
    `python -m humannerf_tpu_torch.run --type movement --cfg <yaml>
    pallas.analytic_bands True`: `run.main` with those arguments in this
    process, so that the launch counts can be read. The default widths, the
    smoke's weights as the checkpoint, a synthetic dataset of two 128 x 128
    frames. The same CLI without the override must write the same PNGs up
    to one level of 255, and launch no K5."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from PIL import Image
    from synthetic_data import write_synthetic_dataset

    from humannerf_tpu_torch import run as run_cli
    base_env = os.environ.get("HUMANNERF_LOGDIR_BASE")
    with tempfile.TemporaryDirectory() as tmp:
        ds = write_synthetic_dataset(os.path.join(tmp, "dataset"),
                                     n_frames=2, size=128)
        cfg_file = os.path.join(tmp, "cli.yaml")
        with open(cfg_file, "w") as f:     # JSON is YAML
            json.dump({"movement": {"dataset": ds},
                       "eval": {"metrics": ["psnr", "ssim"]}}, f)
        os.environ["HUMANNERF_LOGDIR_BASE"] = os.path.join(tmp, "exp")
        try:
            logdir = make_cfg(cfg_file).logdir
            os.makedirs(logdir, exist_ok=True)
            with open(ckpt.ckpt_path(logdir, "latest"), "wb") as f:
                pickle.dump({"iter": 7, "params": ckpt.params_to_numpy(params),
                             "opt_state": None}, f)
            out_dir = os.path.join(logdir, "latest")
            imgs, report = {}, {}
            for route, opts in (("analytic", ["pallas.analytic_bands",
                                              "True"]), ("default", [])):
                fused_mlp.launches = composite.launches = 0
                trilerp.launches = 0
                t0 = time.time()
                run_cli.main(["--type", "movement", "--cfg", cfg_file] + opts)
                secs = time.time() - t0
                pngs = sorted(os.listdir(os.path.join(out_dir, "movement")))
                imgs[route] = [np.asarray(Image.open(os.path.join(
                    out_dir, "movement", n)), np.int16) for n in pngs]
                with open(os.path.join(
                        out_dir, "movement-metrics.average.txt")) as f:
                    avg = f.read().split()[-2:]   # this run's p: and s:
                report[route] = {"seconds": secs, "pngs": pngs,
                                 "launches": {"fused_mlp": fused_mlp.launches,
                                              "trilerp": trilerp.launches},
                                 "metrics": avg}
        finally:
            if base_env is None:
                os.environ.pop("HUMANNERF_LOGDIR_BASE", None)
            else:
                os.environ["HUMANNERF_LOGDIR_BASE"] = base_env
    a, d = imgs["analytic"], imgs["default"]
    levels = max(int(np.abs(x - y).max()) for x, y in zip(a, d)) \
        if len(a) == len(d) == 2 else None
    emit("cli_analytic", **report, max_level_diff=levels, tolerance_levels=1)
    if report["analytic"]["launches"]["trilerp"] <= 0 \
            or report["analytic"]["launches"]["fused_mlp"] <= 0:
        fail(f"cli_analytic: the CLI with pallas.analytic_bands True "
             f"launched {report['analytic']['launches']}")
    if report["default"]["launches"]["trilerp"]:
        fail("cli_analytic: the default route launched K5")
    if levels is None or levels > 1:
        fail(f"cli_analytic: {len(a)} and {len(d)} PNGs, differing by "
             f"{levels} levels (tolerance 1)")


def check_outputs(name, outs, n_rays):
    for o in outs:
        for k, shape in (("rgb", (n_rays, 3)), ("alpha", (n_rays,)),
                         ("depth", (n_rays,))):
            if o[k].shape != shape:
                fail(f"{name}: {k} has shape {o[k].shape}, expected {shape}")
            if not np.isfinite(o[k]).all():
                fail(f"{name}: non-finite {k}")


def max_diff(a, b):
    return {k: float(np.abs(a[k] - b[k]).max())
            for k in ("rgb", "alpha", "depth")}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(ALL_PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in ALL_PHASES + EXTRA_PHASES:
            fail(f"unknown phase {p!r}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    t_start = time.time()
    dev = runtime.setup()
    smi_line = phase_device() if "device" in phases else None
    if "build" in phases:
        phase_build()

    n_rays = N_RAYS
    n_blocks = -(-n_rays // CHUNK)
    cfg = make_cfg(opts=["eval.metrics", "['psnr', 'ssim']"])
    cfg_analytic = make_cfg(opts=["eval.metrics", "['psnr', 'ssim']",
                                  "pallas.analytic_bands", "True"])
    net0 = HumanNeRF(cfg)
    params = smoke_params(net0, SEED)
    params_init = net0.init_params(SEED)   # offsets at their initial 1e-5
    items = [synthetic_item(cfg, n_rays, SEED + i) for i in range(N_FRAMES)]

    titem = train_item(cfg, SEED + 10)
    kernels = {}
    if "kernels" in phases:
        kernels = phase_kernels(net0, params, CHUNK)
        kernels.update(phase_kernels_backward(
            net0, params, params_init,
            training_shapes(net0, params, titem)))
        kernels.update(phase_kernels_trilerp(cfg_analytic, params, items[0]))
        torch.cuda.empty_cache()

    if "profile" in phases:
        phase_profile(cfg, params, items[0])
    if "profile_analytic" in phases:
        phase_profile(cfg_analytic, params, items[0], "profile_analytic")

    base = None
    if "render" in phases or "render_composite" in phases \
            or "checkpoint" in phases:
        outs, secs, counts, net = render_frames(cfg, params, items)
        check_outputs("render", outs, n_rays)
        base = outs
        if counts["fused_mlp"] != n_blocks * len(items):
            fail(f"render: {counts['fused_mlp']} K1 launches, expected "
                 f"{n_blocks * len(items)} (one per block)")
        alpha = np.concatenate([o["alpha"] for o in outs])
        if not (alpha > 0).any() or not (alpha == 0).any():
            fail("render: expected some alpha > 0 and some == 0")
        # the same render forced through the plain versions
        cfg_p = make_cfg(opts=["eval.metrics", "['psnr', 'ssim']",
                               "pallas.mlp", "False"])
        outs_p, secs_p, counts_p, _ = render_frames(cfg_p, params, items[:1])
        if counts_p["fused_mlp"] != 0:
            fail("plain render launched the kernel")
        d = max_diff(outs[0], outs_p[0])
        best = min(secs[1:]) if len(secs) > 1 else secs[0]
        emit("render", frames=len(items), rays=n_rays, samples=cfg.N_samples,
             blocks_per_frame=n_blocks, seconds=secs,
             ray_samples_per_s=n_rays * cfg.N_samples / best,
             plain_seconds=secs_p, dead_tile_share=net.dead_tile_share(),
             launches=counts, alpha_pos_share=float((alpha > 0).mean()),
             vs_plain=d, tolerance_rgb=2e-2)
        if not d["rgb"] <= 2e-2:
            fail(f"render: rgb differs from the plain render by {d['rgb']}")
        if "bf16" in kernels:
            kernels["bf16"]["launches"] = counts["fused_mlp"]

    if "render_f32" in phases:
        for skip in (False, True):
            opts = ["eval.metrics", "['psnr', 'ssim']", "dtype", "float32",
                    "ignore_non_rigid_motions", str(skip)]
            outs, secs, counts, net = render_frames(
                make_cfg(opts=opts), params, items[:1])
            check_outputs("render_f32", outs, n_rays)
            outs_p, _, _, _ = render_frames(
                make_cfg(opts=opts + ["pallas.mlp", "False"]), params,
                items[:1])
            d = max_diff(outs[0], outs_p[0])
            emit("render_f32", ignore_non_rigid=skip, seconds=secs,
                 launches=counts, vs_plain=d, tolerance_rgb=1e-3,
                 dead_tile_share=net.dead_tile_share())
            if counts["fused_mlp"] != n_blocks:
                fail("render_f32: wrong K1 launch count")
            if not d["rgb"] <= 1e-3:
                fail(f"render_f32: rgb differs from plain by {d['rgb']}")
            key = "f32,skip_nr" if skip else "f32"
            if key in kernels:
                kernels[key]["launches"] = counts["fused_mlp"]

    if "render_composite" in phases:
        cfg_c = make_cfg(opts=["eval.metrics", "['psnr', 'ssim']",
                               "pallas.composite", "True"])
        outs, secs, counts, _ = render_frames(cfg_c, params, items[:1])
        check_outputs("render_composite", outs, n_rays)
        d = max_diff(outs[0], base[0])
        emit("render_composite", seconds=secs, launches=counts,
             vs_render=d, tolerance=1e-4)
        if counts["composite"] != n_blocks:
            fail(f"render_composite: {counts['composite']} K6 launches, "
                 f"expected {n_blocks}")
        if max(d.values()) > 1e-4:
            fail(f"render_composite: differs from the render phase: {d}")
        if "composite" in kernels:
            kernels["composite"]["launches"] = counts["composite"]

    if "checkpoint" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            cfg_k = make_cfg(opts=["eval.metrics", "['psnr', 'ssim']"],
                             base_dir=tmp)
            # the JAX package's pickle layout: {iter, params, opt_state}
            os.makedirs(cfg_k.logdir, exist_ok=True)
            with open(ckpt.ckpt_path(cfg_k.logdir, "latest"), "wb") as f:
                pickle.dump({"iter": 7, "params": ckpt.params_to_numpy(params),
                             "opt_state": None}, f)
            from humannerf_tpu_torch.render import load_network
            net_k, params_k = load_network(cfg_k)
            out = EvalRenderer(net_k, chunk=CHUNK).render_frame(
                params_k, items[0], cfg_k.eval_iter)
        d = max_diff(out, base[0])
        # same weights, same code: equal up to the summation order of the
        # float32 library reductions, which may differ between two calls
        emit("checkpoint", vs_render=d, tolerance=1e-5)
        if max(d.values()) > 1e-5:
            fail(f"checkpoint: reloaded weights render differently: {d}")

    if "ignore_non_rigid" in phases:
        cfg_i = make_cfg(opts=["eval.metrics", "['psnr', 'ssim']",
                               "ignore_non_rigid_motions", "True"])
        outs, secs, counts, net = render_frames(cfg_i, params, items[:1])
        check_outputs("ignore_non_rigid", outs, n_rays)
        emit("ignore_non_rigid", seconds=secs, launches=counts,
             dead_tile_share=net.dead_tile_share())
        if counts["fused_mlp"] != n_blocks:
            fail("ignore_non_rigid: wrong K1 launch count")
        if "bf16,skip_nr" in kernels:
            kernels["bf16,skip_nr"]["launches"] = counts["fused_mlp"]

    if "render_analytic" in phases:
        phase_render_analytic(params, items, base, kernels)
    if "cli_analytic" in phases:
        phase_cli_analytic(params)

    with tempfile.TemporaryDirectory() as tmp:
        if "train" in phases:
            phase_train(tmp + "/train", params, titem, kernels)
        if "train_f32" in phases:
            phase_train_f32(tmp + "/train_f32", params, titem, kernels)
        if "train_resume" in phases:
            phase_train_resume(tmp + "/resume", params, titem)
        if "profile_train" in phases:
            phase_profile_train(tmp + "/profile", params, titem)
        if "profile_train_f32" in phases:
            phase_profile_train(tmp + "/profile_f32", params, titem,
                                ["dtype", "float32"], "profile_train_f32")
        if "step_accuracy" in phases:
            phase_step_accuracy(tmp + "/accuracy", params, titem)

    full = set(phases) >= set(ALL_PHASES)
    if full:
        for k in kernels.values():
            if k["launches"] <= 0:
                fail(f"{k['name']} was never launched on the main paths")
    emit("total", seconds=round(time.time() - t_start, 1))
    if smi_line is not None:
        print(smi_line, flush=True)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
