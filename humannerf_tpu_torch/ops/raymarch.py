"""Ray sampling and volume compositing (mirrors humannerf_tpu/ops/raymarch.py).

`raw2outputs` is also the plain version of the compositing kernel
(ops/composite.py): the CPU tests run it, and on the card it is what the
kernel is held against. Training composites with it under autograd.
"""

from __future__ import annotations

import torch


def sample_along_rays(near: torch.Tensor, far: torch.Tensor,
                      n_samples: int) -> torch.Tensor:
    """Linear depth samples: z = near*(1-t) + far*t."""
    t = torch.linspace(0.0, 1.0, n_samples, dtype=near.dtype,
                       device=near.device)
    return near[..., None] * (1.0 - t) + far[..., None] * t


def stratified_sampling(z_vals: torch.Tensor,
                        generator: torch.Generator | None = None,
                        noise: torch.Tensor | None = None) -> torch.Tensor:
    """Jitter samples uniformly within their bins. The uniform numbers in
    [0, 1) come from `noise` (z_vals' shape) when given, else from
    `generator` (which must live on z_vals' device)."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    if noise is None:
        noise = torch.rand(z_vals.shape, generator=generator,
                           dtype=z_vals.dtype, device=z_vals.device)
    elif noise.shape != z_vals.shape:
        raise ValueError(f"noise has shape {tuple(noise.shape)}, expected "
                         f"{tuple(z_vals.shape)}")
    return lower + (upper - lower) * noise


def raw2outputs(raw: torch.Tensor, raw_mask: torch.Tensor,
                z_vals: torch.Tensor, rays_d: torch.Tensor,
                bgcolor: torch.Tensor):
    """Alpha-composite raw MLP outputs along rays.

      dists: z-deltas with a 1e10 tail, scaled by |rays_d|
      alpha = (1 - exp(-relu(sigma) * dist)) * fg_likelihood
      weights = alpha * exclusive-cumprod(1 - alpha + 1e-10)
      rgb_map += (1 - acc) * bgcolor / 255

    raw (R, S, 4); raw_mask (R, S, 1); z_vals (R, S); rays_d (R, 3);
    bgcolor (3,) in [0, 255]. Returns rgb (R, 3), alpha (R,), depth (R,),
    weights_on_rays (R, S), rgb_on_rays (R, S, 3).
    """
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)

    rgb = torch.sigmoid(raw[..., :3])
    alpha = 1.0 - torch.exp(-torch.relu(raw[..., 3]) * dists)
    alpha = alpha * raw_mask[..., 0]

    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10],
                  dim=-1), dim=-1)[..., :-1]
    weights = alpha * trans                                   # (R, S)

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    rgb_map = rgb_map + (1.0 - acc_map[..., None]) * bgcolor[None, :] / 255.0
    return {"rgb": rgb_map, "alpha": acc_map, "depth": depth_map,
            "weights_on_rays": weights, "rgb_on_rays": rgb}
