"""Rendering / evaluation entry point (counterpart of humannerf_tpu/render.py).

Run types: movement, freeview, tpose, tpose_pose_condition, novelview,
novelview_all, novelpose, novelpose_eval, train_render. Each loads a
checkpoint (the JAX package's pickle), iterates the matching dataset,
renders frame by frame, scatters rays back into images, and writes PNG/mp4
+ PSNR/SSIM/LPIPS (`eval.metrics`) where ground truth exists. Without
converted VGG weights (`lpips.weights`) LPIPS runs on the seeded random
trunk and its values are not comparable to published ones. With
RETURN_POSE=true in the environment it also dumps each frame's pose-refiner
output, as the JAX package does.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from humannerf_tpu_torch.data.loader import Loader, create_dataset
from humannerf_tpu_torch.models import mlps
from humannerf_tpu_torch.models.network import HumanNeRF
from humannerf_tpu_torch.train import checkpoint as ckpt
from humannerf_tpu_torch.train.trainer import EvalRenderer
from humannerf_tpu_torch.utils.image import (ImageWriter, to_8b_image,
                                             unpack_to_image)
from humannerf_tpu_torch.utils.metrics import MetricsWriter

# run types whose dataset yields ground truth for metrics
_EVAL_TYPES = {"movement", "novelview", "novelview_all", "novelpose_eval",
               "train_render"}


def load_network(cfg, device=None):
    """Network + parameters from the checkpoint `cfg.load_net` in
    `cfg.logdir`; the tree must match the configured network's."""
    net = HumanNeRF(cfg, device=device)
    payload = ckpt.load_checkpoint(cfg.logdir, cfg.load_net)
    params = ckpt.params_from_jax(payload["params"], device=net.device)
    ckpt.check_like(params, net.init_params(cfg.random_seed))
    print(f"loaded checkpoint {cfg.load_net} (iter {payload['iter']})")
    return net, params


def resolve_render_mode(cfg, run_type: str, environ=None):
    """Output folder name + non-rigid gating per run type.

    tpose renders the canonical pose without the non-rigid field;
    tpose_pose_condition likewise unless FORCE_NON_RIGID_MOTIONS=1, which
    keeps the delta and renders into a '_w-delta' folder.
    cfg.render_folder_name overrides the folder in every mode."""
    environ = os.environ if environ is None else environ
    named = cfg.get_path("render_folder_name", "")
    folder = named or run_type
    ignore_nr = bool(cfg.ignore_non_rigid_motions)
    if run_type == "tpose":
        ignore_nr = True
    elif run_type == "tpose_pose_condition":
        if int(environ.get("FORCE_NON_RIGID_MOTIONS", 0)) == 1:
            if not named:
                folder = run_type + "_w-delta"
        else:
            ignore_nr = True
    return folder, ignore_nr


def pose_refine_output(net, params, item) -> dict:
    """The pose refiner's output for one frame's `dst_posevec` as numpy:
    {'Rs': (total_bones - 1, 3, 3), 'rvec': (total_bones - 1, 3)}."""
    posevec = torch.as_tensor(np.asarray(item["dst_posevec"], np.float32),
                              device=net.device)
    with torch.no_grad():
        po = mlps.apply_pose_refiner(
            params["pose_decoder"], posevec, total_bones=net.cfg.total_bones,
            dtype=net.compute_dtype)
    return {k: v.detach().cpu().numpy() for k, v in po.items()}


def run(cfg, run_type: str, device=None):
    folder, cfg.ignore_non_rigid_motions = resolve_render_mode(cfg, run_type)
    if cfg.multihead.head_num > 1:
        raise NotImplementedError(
            "multihead rendering is not ported yet: ROADMAP.md item A4")
    if cfg.test.save_3d or cfg.test.save_3d_together:
        raise NotImplementedError(
            "3D dumps need full_outputs, not ported yet: ROADMAP.md item A5")
    # RETURN_POSE=true dumps each frame's pose-refiner output, as the JAX
    # package does, to <out_dir>/<folder>-pose_refine_output.pkl
    return_pose = os.environ.get("RETURN_POSE", "False").lower() == "true"
    pose_dump = {}
    net, params = load_network(cfg, device=device)
    renderer = EvalRenderer(net, chunk=min(cfg.chunk, 8192))
    dataset = create_dataset(cfg, run_type)
    loader = Loader(dataset, shuffle=False, prefetch=2)

    out_dir = os.path.join(cfg.logdir, cfg.load_net + cfg.eval_output_tag)
    writer = ImageWriter(out_dir, folder)
    metrics = None
    if run_type in _EVAL_TYPES:
        kw = {}
        if "lpips" in cfg.eval.metrics:
            from humannerf_tpu_torch.models.lpips import (
                init_lpips_params, lpips_trunk_kind, make_lpips_metric_fn)
            if lpips_trunk_kind(cfg.lpips.weights) == "random":
                print("WARNING: LPIPS metric is running on the RANDOM VGG "
                      "trunk (no converted weights at "
                      f"{cfg.lpips.weights!r}); reported values are "
                      "uncalibrated")
            kw = {"lpips_fn": make_lpips_metric_fn(
                      init_lpips_params(cfg.lpips.weights,
                                        device=net.device)),
                  "lpips_trunk": lpips_trunk_kind(cfg.lpips.weights)}
        metrics = MetricsWriter(out_dir, folder,
                                dataset=cfg[run_type].get("dataset", "?"),
                                metrics=cfg.eval.metrics, **kw)

    bg = np.array(cfg.bgcolor, np.float32) / 255.0
    for step, item in enumerate(loader):
        out = renderer.render_frame(params, item, cfg.eval_iter)
        W, H = item["img_width"], item["img_height"]
        truth = item.get("target_rgbs")
        name = item.get("frame_name", f"{step:06d}").replace("/", "-")
        if return_pose and not cfg.pose_decoder_off:
            pose_dump[name] = pose_refine_output(net, params, item)
        rgb_img, alpha_img, truth_img = unpack_to_image(
            W, H, item["ray_mask"], bg, out["rgb"], alpha=out["alpha"],
            truth=truth if truth is not None and truth.ndim == 2 else None)
        if truth is not None and truth.ndim == 3:
            truth_img = to_8b_image(truth)

        imgs = [rgb_img]
        if cfg.show_truth and truth_img is not None:
            imgs.append(truth_img)
        if cfg.show_alpha and alpha_img is not None:
            imgs.append(alpha_img)
        writer.append(np.concatenate(imgs, axis=1), img_name=f"{step:06d}")
        if metrics is not None and truth_img is not None:
            metrics.append(name if name not in metrics.per_image
                           else f"{name}_{step}", rgb_img, truth_img)

    if pose_dump:
        with open(os.path.join(out_dir, f"{folder}-pose_refine_output.pkl"),
                  "wb") as f:
            pickle.dump(pose_dump, f)
    writer.finalize()
    if metrics is not None:
        avg = metrics.finalize()
        print("metrics:", {k: round(v, 4) for k, v in avg.items()})
        return avg
    return None
