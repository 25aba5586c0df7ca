"""Positional embedders (mirrors humannerf_tpu/models/embedders.py).

Feature ordering matches the JAX package exactly (interleaved sin/cos per
frequency, optional leading identity). The band-unlock schedule is a
function of a host-side Python float: the iteration never lives on the
device, so the kick-in gates cost no synchronisation.
"""

from __future__ import annotations

import numpy as np
import torch


def fourier_embed_dim(multires: int, input_dims: int = 3,
                      include_input: bool = True) -> int:
    return input_dims * (2 * multires + (1 if include_input else 0))


def fourier_embed(x: torch.Tensor, multires: int,
                  include_input: bool = True) -> torch.Tensor:
    """[x?, sin(x*2^0), cos(x*2^0), ..., sin(x*2^(m-1)), cos(x*2^(m-1))]."""
    feats = [x] if include_input else []
    for i in range(multires):
        freq = 2.0 ** i
        feats.append(torch.sin(x * freq))
        feats.append(torch.cos(x * freq))
    return torch.cat(feats, dim=-1)


def hann_alpha(iter_val: float, multires: int, kick_in_iter: int,
               full_band_iter: int) -> float:
    """alpha = m * (iter - T_s) / (T_e - T_s), clipped at 0 (m if T_e == T_s)."""
    n = full_band_iter - kick_in_iter
    if n <= 0:
        return float(multires)
    t = max(float(iter_val) - float(kick_in_iter), 0.0)
    return multires * t / float(n)


def hann_window_weights(alpha: float, multires: int) -> list:
    """w_j = (1 - cos(pi * clip(alpha - j, 0, 1))) / 2 for j = 0..m-1.

    Computed in float32 on the host (numpy), as the JAX package computes it
    in float32 on the device: in training the window scales an embedding
    Jacobian, so it should be the same float32 numbers. Returned as Python
    floats that are exactly float32 values."""
    j = np.arange(multires, dtype=np.float32)
    t = np.clip(np.float32(alpha) - j, np.float32(0.0), np.float32(1.0))
    w = (np.float32(1.0) - np.cos(np.float32(np.pi) * t)) / np.float32(2.0)
    return [float(v) for v in w.astype(np.float32)]


def hannw_fourier_embed(x: torch.Tensor, multires: int,
                        alpha: float) -> torch.Tensor:
    """[w_0 sin(x), w_0 cos(x), w_1 sin(2x), w_1 cos(2x), ...], no identity."""
    w = hann_window_weights(alpha, multires)
    feats = []
    for i in range(multires):
        freq = 2.0 ** i
        feats.append(w[i] * torch.sin(x * freq))
        feats.append(w[i] * torch.cos(x * freq))
    return torch.cat(feats, dim=-1)
