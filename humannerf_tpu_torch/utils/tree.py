"""Helpers over nested dicts / lists of tensors (parameter and gradient
trees), shared by the on-card checks and the kernel tests."""

from __future__ import annotations

import torch


def leafify(tree):
    """Deep copy of a tensor tree as leaves that require grad."""
    if isinstance(tree, dict):
        return {k: leafify(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [leafify(v) for v in tree]
    return tree.detach().clone().requires_grad_(True)


def flat_leaves(tree, prefix: str = "") -> dict:
    """{dotted path: tensor} over a nested dict / list of tensors."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat_leaves(v, f"{prefix}.{k}" if prefix else k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat_leaves(v, f"{prefix}[{i}]"))
    else:
        out[prefix] = tree
    return out


def flat_grads(tree) -> dict:
    """{dotted path: gradient} of the leaves that have one."""
    return {k: t.grad for k, t in flat_leaves(tree).items()
            if t.grad is not None}


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| in float32 (relative L2 error of a against b)."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))
