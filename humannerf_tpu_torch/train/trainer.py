"""Training loop and eval renderer
(counterpart of humannerf_tpu/train/trainer.py).

One step = `render_rays(train=True)` -> patch loss (LPIPS + MSE) -> backward
-> per-module Adam. On a CUDA device with the default config the backward
runs the hand-written kernels (fused MLP, resample, scatter); eagerly, no
compiled step. One frame per step on one device; `frames_per_step > 1` and
a device mesh are ROADMAP.md item A6.

Cadence as the JAX package: log every train.log_interval; progress renders
at {start, 100, 300, 1000, 2500} and every progress.dump_interval; 'latest'
checkpoint every save_checkpt_interval; 'iter_N' every save_model_interval.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from humannerf_tpu_torch.models.network import HumanNeRF
from humannerf_tpu_torch.utils.tracing import ExperimentLogger, StepTimer

FRAME_KEYS = ("dst_Rs", "dst_Ts", "cnl_gtfms", "motion_weights_priors",
              "dst_posevec", "cnl_bbox_min_xyz", "cnl_bbox_scale_xyz",
              "dst_bbox_min_xyz", "dst_bbox_max_xyz", "bgcolor",
              "pose_condition")
RAY_KEYS = ("rays_o", "rays_d", "near", "far")
_HOST_KEYS = ("frame_name", "num_valid_rays")


def split_batch(batch: dict):
    frame = {k: batch[k] for k in FRAME_KEYS if k in batch}
    rays = {k: batch[k] for k in RAY_KEYS}
    return frame, rays


def to_device_batch(item: dict, device) -> dict:
    """One dataset item (numpy) -> tensors on `device`: floats as float32,
    the patch index map as int64."""
    out = {}
    for k, v in item.items():
        if k in _HOST_KEYS or isinstance(v, str):
            continue
        a = np.asarray(v)
        if a.dtype.kind == "f":
            out[k] = torch.from_numpy(np.array(a, np.float32)).to(device)
        elif a.dtype.kind in "iu" and k == "patch_ray_idx":
            out[k] = torch.from_numpy(np.array(a, np.int64)).to(device)
    return out


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


class EvalRenderer:
    """Full-image renderer: pads the masked-ray count to a multiple of
    `chunk` and renders chunk by chunk.

    The JAX package pads to `chunk * 2^k` buckets only to bound the number
    of compiled programs; PyTorch runs eagerly, so the port pads no further
    than the next multiple of `chunk` (every block then has one shape).
    """

    def __init__(self, net: HumanNeRF, chunk: int = 8192):
        self.net = net
        self.chunk = chunk

    def render_frame(self, params, item: dict, iter_val: float,
                     full_outputs: bool = False, head_mode: str = "single",
                     head_id: int = 0) -> dict:
        """item: one dataset item (numpy). -> numpy rgb (n, 3), alpha (n,),
        depth (n,) for its n masked rays."""
        dev = self.net.device
        n = item["rays_o"].shape[0]
        n_pad = max(-(-n // self.chunk), 1) * self.chunk
        rays = {}
        for k in RAY_KEYS:
            v = np.asarray(item[k], np.float32)
            pad = np.zeros((n_pad - n,) + v.shape[1:], np.float32)
            rays[k] = torch.from_numpy(np.concatenate([v, pad], axis=0)
                                       ).to(dev)
        frame = {k: torch.as_tensor(np.asarray(item[k], np.float32)).to(dev)
                 for k in FRAME_KEYS if k in item}
        with torch.no_grad():
            out = self.net.render_rays(params, frame, rays, float(iter_val),
                                       chunk=min(self.chunk, n_pad),
                                       perturb=False,
                                       full_outputs=full_outputs,
                                       head_mode=head_mode)
        return {k: v[:n].cpu().numpy() for k, v in out.items()}


class Trainer:
    def __init__(self, cfg, mesh=None, log=print, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh is not ported yet: ROADMAP.md item A6 (more "
                "than one device)")
        if int(cfg.train.frames_per_step) != 1:
            raise NotImplementedError(
                "train.frames_per_step > 1 is not ported yet: ROADMAP.md "
                "item A6 (more than one device)")
        if cfg.train.ray_shoot_mode != "patch":
            raise ValueError("training needs train.ray_shoot_mode 'patch'")
        self.cfg = cfg
        self.log = log
        self.net = HumanNeRF(cfg, device=device)
        dev = self.device = self.net.device
        # two streams of random numbers, as the JAX package splits its key:
        # one for the initial weights (CPU), one for the depth jitter
        self.init_gen = torch.Generator().manual_seed(int(cfg.random_seed))
        self.gen = torch.Generator(device=dev).manual_seed(
            int(cfg.random_seed) + 1)

        params = self.net.init_params(self.init_gen)
        from humannerf_tpu_torch.train.modules import apply_pretrained_modules
        params, frozen = apply_pretrained_modules(cfg, params, device=dev)
        if frozen:
            self.log(f"frozen pretrained modules: {frozen}")
        self.frozen = tuple(frozen)
        self.lossweights = {k: float(v)
                            for k, v in cfg.train.lossweights.items()}
        self.lpips_params = None
        if self.lossweights.get("lpips", 0) > 0:
            from humannerf_tpu_torch.models.lpips import (init_lpips_params,
                                                          lpips_trunk_kind)
            self.lpips_params = init_lpips_params(cfg.lpips.weights,
                                                  device=dev)
            if lpips_trunk_kind(cfg.lpips.weights) == "random":
                self.log("WARNING: LPIPS loss is running on the RANDOM VGG "
                         "trunk (no converted weights at "
                         f"{cfg.lpips.weights!r}); logged lpips values are "
                         "uncalibrated")

        from humannerf_tpu_torch.train import checkpoint as ckpt
        self.iter = 1
        payload = None
        if cfg.resume and ckpt.ckpt_exists(cfg.logdir, cfg.load_net):
            payload = ckpt.load_checkpoint(cfg.logdir, cfg.load_net)
            params = ckpt.restore_params(payload, params)
        self.set_params(params)
        if payload is not None:
            ckpt.opt_state_from_jax(payload.get("opt_state"), self.optimizer,
                                    self.scheduler, self.params, self.labels)
            self.iter = payload["iter"] + 1
            self.log(f"resumed from {cfg.load_net} at iter {self.iter}")
        else:
            self.save("init", 0)
        self.start_iter = self.iter
        self.renderer = EvalRenderer(self.net, chunk=min(cfg.chunk, 8192))

    # -- state -------------------------------------------------------------

    def set_params(self, params):
        """Adopt `params` (a tree of tensors) as the trainable leaves and
        build a fresh optimizer over them."""
        from humannerf_tpu_torch.train.optimizer import make_optimizer
        dev = self.device
        self.params = tree_map(
            lambda t: t.detach().to(dev, torch.float32).clone()
            .requires_grad_(True), params)
        for mod in self.frozen:
            tree_map(lambda t: t.requires_grad_(False), self.params[mod])
        self.optimizer, self.scheduler, self.labels = make_optimizer(
            self.cfg, self.params, self.frozen)

    def save(self, name: str, iter_val: int):
        from humannerf_tpu_torch.train import checkpoint as ckpt
        from humannerf_tpu_torch.train.optimizer import customized_lr_names
        names = ["base"] + customized_lr_names(self.cfg)
        return ckpt.save_checkpoint(
            self.cfg.logdir, name, iter_val, self.params,
            ckpt.opt_state_to_jax(self.optimizer, self.scheduler, self.params,
                                  self.labels, names))

    # -- one step -----------------------------------------------------------

    def _loss_fn(self, params, batch, generator, iter_val, noise=None):
        """-> (loss, {name: term}). Exposed for the parity tests, as in the
        JAX package: gradients are the honest signal, since one Adam step
        normalises a gradient's scale away."""
        from humannerf_tpu_torch.train.loss import (gather_patch_images,
                                                    image_losses, total_loss)
        cfg = self.cfg
        frame, rays = split_batch(batch)
        out = self.net.render_rays(
            params, frame, rays, float(iter_val), generator,
            perturb=cfg.train.perturb > 0,
            remat=bool(cfg.train.get("remat", True)), train=True, noise=noise)
        patch_imgs = gather_patch_images(
            out["rgb"], batch["patch_ray_idx"], batch["bgcolor"] / 255.0)
        names = [k for k, w in self.lossweights.items() if w > 0]
        losses = image_losses(patch_imgs, batch["target_patches"], names,
                              self.lpips_params, tuple(cfg.lpips.layers))
        return total_loss(losses, self.lossweights)

    def train_step(self, batch, noise=None):
        """Forward, backward and one optimizer update on one frame's batch
        of tensors. -> (loss, {name: term}) as detached tensors."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, terms = self._loss_fn(self.params, batch, self.gen, self.iter,
                                    noise=noise)
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        return loss.detach(), {k: v.detach() for k, v in terms.items()}

    # -- loop ---------------------------------------------------------------

    def train(self, loader=None, max_steps=None):
        from humannerf_tpu_torch.data.loader import Loader, create_dataset
        cfg = self.cfg
        if loader is None:
            dataset = create_dataset(cfg, "train", seed=cfg.random_seed)
            loader = Loader(dataset, shuffle=cfg.train.shuffle,
                            seed=cfg.random_seed)
        maxiter = cfg.train.maxiter if max_steps is None \
            else self.iter + max_steps - 1
        os.makedirs(cfg.logdir, exist_ok=True)
        timer = StepTimer()
        exp_log = ExperimentLogger(cfg.logdir)
        stream = loader.endless()
        try:
            while self.iter <= maxiter:
                batch = to_device_batch(next(stream), self.device)
                loss, terms = self.train_step(batch)
                timer.tick()
                if self.iter % cfg.train.log_interval == 0:
                    loss_v = float(loss)
                    metrics = {k: float(v) for k, v in terms.items()}
                    items = " ".join(f"{k}: {v:.4f}"
                                     for k, v in metrics.items())
                    self.log(f"[iter {self.iter}] loss {loss_v:.4f} "
                             f"[{items}] ({timer.rate():.2f} it/s)")
                    exp_log.log({"loss": loss_v, "it_per_sec": timer.rate(),
                                 **metrics}, step=self.iter)
                if (self.iter in (self.start_iter, 100, 300, 1000, 2500)
                        or self.iter % cfg.progress.dump_interval == 0):
                    try:
                        self.progress()
                    except FileNotFoundError:
                        pass    # no progress dataset prepared (smoke runs)
                if (self.iter % cfg.train.save_checkpt_interval == 0
                        or self.iter == self.start_iter):
                    self.save("latest", self.iter)
                if (cfg.save_all
                        and self.iter % cfg.train.save_model_interval == 0):
                    self.save(f"iter_{self.iter}", self.iter)
                self.iter += 1
        finally:
            exp_log.finish()

    def finalize(self):
        self.save("latest", self.iter)

    # -- progress renders ---------------------------------------------------

    def progress(self) -> bool:
        """Render held-out frames against ground truth into prog_{iter}.jpg.
        Returns the empty-image divergence signal."""
        from humannerf_tpu_torch.data.loader import create_dataset
        from humannerf_tpu_torch.utils.image import (tile_images,
                                                     unpack_to_image)
        cfg = self.cfg
        if "dataset" not in cfg.progress:
            raise FileNotFoundError("no progress dataset configured")
        dataset = create_dataset(cfg, "progress")
        images = []
        is_empty = False
        params = tree_map(lambda t: t.detach(), self.params)
        bg = np.array(cfg.bgcolor, np.float32) / 255.0
        for i in range(len(dataset)):
            item = dataset[i]
            out = self.renderer.render_frame(params, item, self.iter)
            rgb_img, _, truth_img = unpack_to_image(
                item["img_width"], item["img_height"], item["ray_mask"], bg,
                out["rgb"], truth=item.get("target_rgbs"))
            images.append(np.concatenate(
                [rgb_img, truth_img if truth_img is not None else rgb_img],
                axis=1))
            if self.iter <= 5000 and np.allclose(
                    rgb_img, np.array(cfg.bgcolor), atol=5.0):
                is_empty = True
        os.makedirs(cfg.logdir, exist_ok=True)
        from PIL import Image
        Image.fromarray(tile_images(images)).save(
            os.path.join(cfg.logdir, f"prog_{self.iter:06d}.jpg"))
        if is_empty:
            self.log("progress renders are empty (divergence signal)")
        return is_empty
