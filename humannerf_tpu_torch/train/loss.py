"""Training loss: rendered rays -> patch images -> LPIPS + MSE (+ L1)
(mirrors humannerf_tpu/train/loss.py; `argmin_multihead_loss` and the
in-graph SSIM belong to the multihead family, ROADMAP.md item A4).

The data layer precomputes `patch_ray_idx` (an integer pixel -> ray-slot
map, -1 = background), so patch assembly is a single gather.
"""

from __future__ import annotations

import torch

from humannerf_tpu_torch.models.lpips import lpips_distance, scale_for_lpips


def gather_patch_images(rgb: torch.Tensor, patch_ray_idx: torch.Tensor,
                        bgcolor01: torch.Tensor) -> torch.Tensor:
    """rgb (R, 3) + idx (N, P, P) -> patch images (N, P, P, 3); background
    pixels (idx == -1) get bgcolor."""
    idx = patch_ray_idx.long()
    gathered = rgb[idx.clamp(min=0)]                        # (N, P, P, 3)
    is_ray = (idx >= 0)[..., None]
    return torch.where(is_ray, gathered, bgcolor01.to(rgb.dtype))


def image_losses(patch_imgs: torch.Tensor, targets: torch.Tensor,
                 loss_names, lpips_params=None, lpips_layers=(0, 1, 2, 3, 4)):
    """Per-loss dict over patch image pairs."""
    losses = {}
    if "mse" in loss_names:
        losses["mse"] = torch.mean((patch_imgs - targets) ** 2)
    if "l1" in loss_names:
        losses["l1"] = torch.mean(torch.abs(patch_imgs - targets))
    if "lpips" in loss_names:
        a = scale_for_lpips(patch_imgs).permute(0, 3, 1, 2)
        b = scale_for_lpips(targets).permute(0, 3, 1, 2)
        losses["lpips"] = torch.mean(
            lpips_distance(lpips_params, a, b, layers=lpips_layers))
    return losses


def total_loss(losses: dict, lossweights: dict):
    """Weighted sum over the loss weights > 0 -> (total, the terms used)."""
    total = 0.0
    out = {}
    for k, w in lossweights.items():
        if w > 0 and k in losses:
            out[k] = losses[k]
            total = total + w * losses[k]
    return total, out
