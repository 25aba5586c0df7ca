"""LPIPS perceptual metric / loss (mirrors humannerf_tpu/models/lpips.py).

v0.1 with the VGG16 trunk: input scaling layer, features at
relu{1_2, 2_2, 3_3, 4_3, 5_3}, unit normalisation, squared differences,
1x1 "lin" calibration heads, spatial average, sum over layers.

Weights: converted weights are read from the same pickle the JAX package
reads (`cfg.lpips.weights`). Without such a file the trunk is the JAX
package's deterministic random one, drawn with numpy from
`RandomState(1234)` in the same order, so both packages hold the same
numbers; the trained lin heads come from the package's own asset
(`assets/lpips_v01_vgg_lins.pkl`). Values from the random trunk are not
comparable to published LPIPS numbers.

The convolutions are `torch.nn.functional.conv2d` in float32 with TF32 off
(`runtime.setup` pins that): the JAX package computes them outside any
Pallas kernel too, in full float32.
"""

from __future__ import annotations

import logging
import math
import os
import pickle

import numpy as np
import torch
import torch.nn.functional as F

logger = logging.getLogger(__name__)

# VGG16 conv plan: (out_channels, layers_per_block). Feature taps are the
# last relu of each block.
VGG_PLAN = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
CHNS = [64, 128, 256, 512, 512]

# the v0.1 input scaling layer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

_ASSET = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "lpips_v01_vgg_lins.pkl")


def lpips_trunk_kind(weights_path: str | None = None) -> str:
    """'converted' when a converted VGG16 trunk file will be loaded,
    'random' when `init_lpips_params` builds the deterministic random trunk."""
    if (weights_path and weights_path != "empty"
            and os.path.isfile(weights_path)):
        return "converted"
    return "random"


def lpips_params_from_jax(tree, device="cpu") -> dict:
    """A numpy tree {'features': [[{'w', 'b'}, ...], ...], 'lins': [{'w'}]}
    (the JAX package's layout: OIHW conv weights) -> float32 tensors."""
    def leaf(x):
        return torch.from_numpy(np.array(np.asarray(x), dtype=np.float32)
                                ).to(device)
    return {
        "features": [[{"w": leaf(p["w"]), "b": leaf(p["b"])} for p in block]
                     for block in tree["features"]],
        "lins": [{"w": leaf(p["w"])} for p in tree["lins"]],
    }


def init_lpips_params(weights_path: str | None = None, seed: int = 1234,
                      device="cpu") -> dict:
    """Load converted weights, or build the deterministic random trunk."""
    if lpips_trunk_kind(weights_path) == "converted":
        with open(weights_path, "rb") as f:
            raw = pickle.load(f)
        return lpips_params_from_jax(raw, device)

    logger.warning(
        "LPIPS VGG16 trunk weights not found (cfg.lpips.weights=%r): using "
        "the deterministic RANDOM trunk. Training still works (fixed random "
        "features), but reported LPIPS values are UNCALIBRATED and not "
        "comparable to published numbers.", weights_path)
    rng = np.random.RandomState(seed)
    tree = {"features": [], "lins": []}
    c_in = 3
    for c_out, n_layers in VGG_PLAN:
        block = []
        for _ in range(n_layers):
            std = math.sqrt(2.0 / (c_in * 9))
            block.append({
                "w": rng.randn(c_out, c_in, 3, 3).astype(np.float32) * std,
                "b": np.zeros((c_out,), np.float32)})
            c_in = c_out
        tree["features"].append(block)
    for ch in CHNS:
        tree["lins"].append({"w": np.full((1, ch, 1, 1), 1.0 / ch,
                                          np.float32)})
    # the trained lin heads: env override, else the package's asset
    lin_path = os.environ.get("LPIPS_LIN_WEIGHTS", "")
    if not (lin_path and os.path.isfile(lin_path)):
        lin_path = _ASSET
    if os.path.isfile(lin_path):
        with open(lin_path, "rb") as f:
            tree["lins"] = [{"w": w} for w in pickle.load(f)]
    return lpips_params_from_jax(tree, device)


def vgg_features(params, x):
    """x: (N, 3, H, W) scaled input -> list of feature maps. Stops before a
    pool would produce an empty map, so tiny patches give fewer than 5."""
    feats = []
    for bi, block in enumerate(params["features"]):
        if bi > 0:
            if min(x.shape[-2:]) < 2:
                break
            x = F.max_pool2d(x, 2, 2)
        for p in block:
            x = torch.relu(F.conv2d(x, p["w"], p["b"], stride=1, padding=1))
        feats.append(x)
    return feats


def _normalize_tensor(x, eps=1e-10):
    norm = torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True))
    return x / (norm + eps)


def lpips_distance(params, in0, in1, layers=(0, 1, 2, 3, 4),
                   use_lins: bool = True):
    """LPIPS(in0, in1) for (N, 3, H, W) images in [-1, 1] -> (N,)."""
    shift = in0.new_tensor(_SHIFT)[None, :, None, None]
    scale = in0.new_tensor(_SCALE)[None, :, None, None]
    f0 = vgg_features(params, (in0 - shift) / scale)
    f1 = vgg_features(params, (in1 - shift) / scale)
    total = 0.0
    for k in [k for k in layers if k < len(f0)]:
        d = (_normalize_tensor(f0[k]) - _normalize_tensor(f1[k])) ** 2
        if use_lins:
            d = torch.sum(d * params["lins"][k]["w"][0][None], dim=1,
                          keepdim=True)
        else:
            d = torch.sum(d, dim=1, keepdim=True)
        total = total + torch.mean(d, dim=(1, 2, 3))
    return total


def scale_for_lpips(x):
    """[0, 1] -> [-1, 1]."""
    return x * 2.0 - 1.0


def make_lpips_metric_fn(params, layers=(0, 1, 2, 3, 4)):
    """-> lpips_fn(pred_hwc, target_hwc) -> float, for MetricsWriter; the
    images are numpy, in [0, 1]."""
    dev = params["lins"][0]["w"].device

    def fn(pred, target):
        def prep(img):
            t = torch.as_tensor(np.asarray(img, np.float32)).to(dev)
            return scale_for_lpips(t).permute(2, 0, 1)[None]
        with torch.no_grad():
            return float(lpips_distance(params, prep(pred), prep(target),
                                        layers=layers)[0])
    return fn
