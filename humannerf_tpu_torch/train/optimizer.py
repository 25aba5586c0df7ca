"""Optimizer: Adam with per-module learning rates + exponential decay
(mirrors humannerf_tpu/train/optimizer.py).

Parameters whose module name contains one of the `cfg.train.lr_<name>` keys
get that base rate; every rate decays as base * 0.1^(step / (lrate_decay *
1000)), the first update using step 0. One `torch.optim.Adam` parameter
group per label, betas (0.9, 0.999), eps 1e-8, and a `LambdaLR` for the
decay. Frozen modules are in no group and get no updates.
"""

from __future__ import annotations

import torch


def customized_lr_names(cfg) -> list:
    return [k[3:] for k in cfg.train.keys() if k.startswith("lr_")]


def label_params(cfg, params) -> dict:
    """Top-level module name -> label of its learning-rate group: the first
    `lr_<name>` key (in cfg.train order) whose name the module's contains,
    else 'base'."""
    names = customized_lr_names(cfg)

    def label_for(module_name: str) -> str:
        for n in names:
            if n in module_name:
                return n
        return "base"
    return {k: label_for(k) for k in params}


def tree_leaves(tree) -> list:
    """Leaves of a nested dict / list in the order `jax.tree.leaves` gives
    them: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def make_optimizer(cfg, params, frozen_modules=()):
    """-> (optimizer, scheduler, labels). `params` leaves must be leaf
    tensors with requires_grad; the optimizer updates them in place.
    frozen_modules: top-level keys that get no updates. labels: module ->
    label, 'frozen' for the frozen ones."""
    labels = label_params(cfg, params)
    for key in frozen_modules:
        labels[key] = "frozen"
    base_lr = {"base": float(cfg.train.lr)}
    for name in customized_lr_names(cfg):
        base_lr[name] = float(cfg.train[f"lr_{name}"])
    groups = {}
    for mod in params:
        label = labels[mod]
        if label == "frozen":
            continue
        groups.setdefault(label, []).extend(tree_leaves(params[mod]))
    param_groups = [{"params": ps, "lr": base_lr[label], "label": label}
                    for label, ps in groups.items()]
    opt = torch.optim.Adam(param_groups, betas=(0.9, 0.999), eps=1e-8)
    decay_steps = float(cfg.train.lrate_decay) * 1000.0
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: 0.1 ** (step / decay_steps))
    return opt, sched, labels
