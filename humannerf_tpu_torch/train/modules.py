"""Partial-module warm start, reinit and freezing
(mirrors humannerf_tpu/train/modules.py).

Load a pretrained checkpoint, adopt module subtrees (unless `reinit`) and
freeze the adopted modules not marked `tune`. The env toggles
LOAD_C / LOAD_D / TUNE_C / TUNE_D map onto the same mechanism (C = canonical
MLP, D = non-rigid MLP). Freezing is an optimizer property: frozen modules
are in no parameter group.
"""

from __future__ import annotations

import os

MODULE_NAMES = ("canonical_mlp", "non_rigid_motion_mlp", "pose_decoder",
                "mweight_vol_decoder")
# cfg.modules key -> param-tree key
_PARAM_KEY = {"canonical_mlp": "cnl_mlp",
              "non_rigid_motion_mlp": "non_rigid_mlp",
              "pose_decoder": "pose_decoder",
              "mweight_vol_decoder": "mweight_vol_decoder"}


def _env_overrides(cfg):
    short = {"C": "canonical_mlp", "D": "non_rigid_motion_mlp"}
    for letter, mod in short.items():
        if os.environ.get(f"LOAD_{letter}", "") == "0":
            cfg.modules[mod].reinit = True
        if int(os.environ.get(f"TUNE_{letter}", 0)) == 1:
            cfg.modules[mod].tune = True
    return cfg


def apply_pretrained_modules(cfg, params, device="cpu"):
    """Warm-start params from cfg.modules.pretrained_path.
    -> (params, frozen_modules): modules loaded from the pretrained
    checkpoint and not marked `tune` are frozen."""
    cfg = _env_overrides(cfg)
    frozen = []
    path = cfg.modules.pretrained_path
    if path == "empty" or not path:
        return params, frozen
    if path.endswith(".tar"):
        raise NotImplementedError(
            "a reference torch checkpoint (.tar) as cfg.modules."
            "pretrained_path needs tools/convert_torch_ckpt.py, not ported "
            "yet: ROADMAP.md item A4")

    from humannerf_tpu_torch.train import checkpoint as ckpt
    pretrained = ckpt.params_from_jax(
        ckpt.load_checkpoint(os.path.dirname(path) or ".", path)["params"],
        device=device)
    for mod in MODULE_NAMES:
        mcfg = cfg.modules[mod]
        pkey = _PARAM_KEY[mod]
        if pkey not in params or pkey not in pretrained:
            continue
        if mcfg.reinit:
            continue  # keep fresh init
        params[pkey] = pretrained[pkey]
        if not mcfg.tune:
            frozen.append(pkey)
    return params, frozen
