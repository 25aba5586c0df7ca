"""Checkpoints: reads the JAX package's pickle, writes the same layout
(counterpart of humannerf_tpu/train/checkpoint.py).

The JAX `train.py` saves {iter, params, opt_state}: `params` is its
parameter tree as numpy arrays, `opt_state` holds optimizer containers
(named tuples) of a package the port does not import. `load_checkpoint`
therefore unpickles with numpy allowed and every other class replaced by a
stand-in that keeps the constructor's arguments; `params_from_jax` carries
the parameter tree across and `opt_state_from_jax` the Adam moments and step
counts, so a checkpoint written by the JAX package is served and resumed by
the port.

The port writes the same layout. Its `opt_state` is `opt_state_to_jax`'s
nest of plain tuples and dicts, shaped like the JAX package's optimizer
state (label -> (count, mu, nu) over the whole parameter tree, empty tuples
where a label does not own a leaf), so that it flattens to the same leaves
in the same order and the JAX package's `restore_into` takes it.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

_LINEAR = ("w", "b")
# the default model family's parameter tree: module -> entry -> kind
_SCHEMA = {
    "mweight_vol_decoder": {"const_embedding": "leaf", "block_mlp": "linear",
                            "block_conv": "linears"},
    "non_rigid_mlp": {"block_mlps": "linears", "output": "linear"},
    "cnl_mlp": {"pts_linears": "linears", "output": "linear"},
    "pose_decoder": {"block_mlps": "linears", "output": "linear"},
}


def ckpt_path(logdir: str, name: str) -> str:
    return os.path.join(logdir, f"{name}.ckpt")


def ckpt_exists(logdir: str, name: str) -> bool:
    return os.path.isfile(ckpt_path(logdir, name))


def _leaf(x, path, device):
    a = np.asarray(x)
    if a.dtype.kind != "f":
        raise TypeError(f"{path}: expected a float array, got {a.dtype}")
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def _linear(p, path, device):
    if not isinstance(p, dict) or set(p) != set(_LINEAR):
        raise KeyError(f"{path}: expected a layer with keys {_LINEAR}, got "
                       f"{sorted(p) if isinstance(p, dict) else type(p)}")
    return {k: _leaf(p[k], f"{path}.{k}", device) for k in _LINEAR}


def params_from_jax(tree: dict, device="cpu") -> dict:
    """The JAX package's parameter tree (numpy leaves) -> the port's.

    Both keep linear weights as (in, out) and transposed-conv weights as
    (I, O, kD, kH, kW), so every leaf crosses unchanged, as float32 on
    `device`. Consumes every leaf of the default model family and raises
    KeyError on a module or entry it does not know (multihead, view-dir,
    encoders ... are not ported: ROADMAP.md item A4).
    """
    out = {}
    for mod, sub in tree.items():
        if mod not in _SCHEMA:
            raise KeyError(f"unknown parameter module {mod!r} (not ported: "
                           f"ROADMAP.md item A4)")
        if not isinstance(sub, dict):
            raise KeyError(f"{mod}: expected a dict of entries")
        conv = {}
        for name, val in sub.items():
            kind = _SCHEMA[mod].get(name)
            path = f"{mod}.{name}"
            if kind is None:
                raise KeyError(f"unknown parameter entry {path!r} (not "
                               f"ported: ROADMAP.md item A4)")
            if kind == "leaf":
                conv[name] = _leaf(val, path, device)
            elif kind == "linear":
                conv[name] = _linear(val, path, device)
            else:
                conv[name] = [_linear(p, f"{path}[{i}]", device)
                              for i, p in enumerate(val)]
        missing = set(_SCHEMA[mod]) - set(conv)
        if missing:
            raise KeyError(f"{mod}: missing entries {sorted(missing)}")
        out[mod] = conv
    return out


def params_to_numpy(params):
    """The port's parameter tree -> nested numpy arrays (the pickle's
    `params` layout, which is also what the JAX package restores from)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    return params.detach().to("cpu", torch.float32).numpy()


def check_like(params, template, path="params"):
    """Raise unless `params` has the tree structure and shapes of
    `template` (the network's own init_params)."""
    if isinstance(template, dict):
        if not isinstance(params, dict) or set(params) != set(template):
            raise ValueError(
                f"{path}: entries {sorted(params)} do not match the "
                f"configured network's {sorted(template)}")
        for k in template:
            check_like(params[k], template[k], f"{path}.{k}")
    elif isinstance(template, (list, tuple)):
        if len(params) != len(template):
            raise ValueError(f"{path}: {len(params)} layers, the configured "
                             f"network has {len(template)}")
        for i, (p, t) in enumerate(zip(params, template)):
            check_like(p, t, f"{path}[{i}]")
    elif tuple(params.shape) != tuple(template.shape):
        raise ValueError(f"{path}: shape {tuple(params.shape)}, the "
                         f"configured network has {tuple(template.shape)}")


def save_checkpoint(logdir: str, name: str, iter_val: int, params,
                    opt_state=None):
    """Atomic write (tmp + fsync + rename) of {iter, params, opt_state}."""
    os.makedirs(logdir, exist_ok=True)
    path = ckpt_path(logdir, name)
    tmp = path + ".tmp"
    payload = {"iter": int(iter_val), "params": params_to_numpy(params),
               "opt_state": opt_state}
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


class _Record:
    """Stand-in for a pickled class of a package the port does not import
    (the optimizer's named-tuple state containers): keeps the class name and
    the constructor's arguments in `fields`."""

    def __new__(cls, *args, **kwargs):
        self = object.__new__(cls)
        self.fields = tuple(args)
        return self

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _NumpyOnlyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in ("numpy", "builtins", "collections"):
            return super().find_class(module, name)
        return type(name, (_Record,), {})


def _fields(x):
    """Fields of a state container: a stand-in record, or the plain tuple
    the port writes in its place."""
    if isinstance(x, _Record):
        return x.fields
    if isinstance(x, tuple):
        return x
    raise TypeError(f"not a state container: {type(x)}")


def _walk_pairs(params, saved, path=""):
    """Yield (path, parameter leaf, saved leaf or None) over the parameter
    tree; a saved subtree of another structure gives None leaves."""
    if isinstance(params, dict):
        for k in params:
            sub = saved.get(k) if isinstance(saved, dict) else None
            yield from _walk_pairs(params[k], sub, f"{path}.{k}")
    elif isinstance(params, (list, tuple)):
        ok = isinstance(saved, (list, tuple)) and len(saved) == len(params)
        for i, v in enumerate(params):
            yield from _walk_pairs(v, saved[i] if ok else None,
                                   f"{path}[{i}]")
    else:
        yield path, params, saved


def _moment(x, like):
    """A saved moment as a tensor like `like`, or None when it is missing,
    a masked placeholder, or of another shape."""
    if x is None or isinstance(x, (_Record, tuple, list, dict)):
        return None
    a = np.asarray(x)
    if a.dtype.kind != "f" or tuple(a.shape) != tuple(like.shape):
        return None
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(like.device)


def opt_state_from_jax(opt_state, optimizer, scheduler, params, labels):
    """Load Adam moments and step counts from a checkpoint's `opt_state`
    (the JAX package's optimizer state, or `opt_state_to_jax`'s nest) into
    `optimizer` / `scheduler` (train/optimizer.make_optimizer's), in place.

    Per label: ScaleByAdamState(count, mu, nu) -> `step`, `exp_avg`,
    `exp_avg_sq` of every parameter of that label. Tolerant: a label or leaf
    that is missing or of another shape keeps its fresh state. Returns the
    number of parameter tensors restored."""
    if opt_state is None:
        return 0
    inner_states = _fields(opt_state)[0]
    restored = 0
    count = None
    for mod, label in labels.items():
        if label == "frozen" or label not in inner_states:
            continue
        inner = _fields(inner_states[label])[0]
        if not isinstance(inner, (tuple, list)) or not inner:
            continue
        adam = _fields(inner[0])
        if len(adam) != 3:
            continue
        c, mu, nu = adam
        mu_mod = mu.get(mod) if isinstance(mu, dict) else None
        nu_mod = nu.get(mod) if isinstance(nu, dict) else None
        for (_, p, m), (_, _, v) in zip(_walk_pairs(params[mod], mu_mod),
                                        _walk_pairs(params[mod], nu_mod)):
            m, v = _moment(m, p), _moment(v, p)
            if m is None or v is None:
                continue
            optimizer.state[p] = {
                "step": torch.tensor(float(np.asarray(c)),
                                     dtype=torch.float32),
                "exp_avg": m, "exp_avg_sq": v}
            restored += 1
            count = int(np.asarray(c))
    if count is not None:
        # the schedule's step count is the number of updates made
        scheduler.last_epoch = count
        lrs = [base * lam(count) for base, lam in
               zip(scheduler.base_lrs, scheduler.lr_lambdas)]
        for group, lr in zip(optimizer.param_groups, lrs):
            group["lr"] = lr
        scheduler._last_lr = lrs
    return restored


def opt_state_to_jax(optimizer, scheduler, params, labels, label_names):
    """The optimizer's state as the nest the JAX package restores from:
    ({label: (((count, mu, nu), (count,)),), 'frozen': ((),)},) with mu / nu
    shaped like `params` (numpy leaves where the label owns the parameter,
    () elsewhere). label_names: every label the JAX optimizer has ('base'
    and one per cfg.train.lr_<name>), owned parameters or not."""
    count = np.asarray(int(scheduler.last_epoch), np.int32)

    def moments(label, key):
        def walk(tree, owned):
            if isinstance(tree, dict):
                return {k: walk(v, owned) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return [walk(v, owned) for v in tree]
            if not owned:
                return ()
            st = optimizer.state.get(tree)
            if not st:
                return np.zeros(tuple(tree.shape), np.float32)
            return st[key].detach().to("cpu", torch.float32).numpy()
        return {mod: walk(params[mod], labels[mod] == label)
                for mod in params}

    inner = {}
    for label in label_names:
        inner[label] = (((count, moments(label, "exp_avg"),
                          moments(label, "exp_avg_sq")), (count,)),)
    inner["frozen"] = ((),)
    return (inner,)


def restore_params(payload: dict, template):
    """Saved parameters merged onto `template` (the network's own tree of
    tensors), tolerating missing keys: what the checkpoint lacks, or holds
    in another shape, keeps the template's value."""
    def merge(saved, tmpl):
        if isinstance(tmpl, dict):
            return {k: merge(saved.get(k) if isinstance(saved, dict)
                             else None, tmpl[k]) for k in tmpl}
        if isinstance(tmpl, (list, tuple)):
            if not isinstance(saved, (list, tuple)) \
                    or len(saved) != len(tmpl):
                return list(tmpl)
            return [merge(s, t) for s, t in zip(saved, tmpl)]
        got = _moment(saved, tmpl)
        return tmpl if got is None else got
    return merge(payload["params"], template)


def load_checkpoint(logdir: str, name: str) -> dict:
    """-> {iter, params (numpy tree), opt_state (stand-in records or the
    port's own nest; read it with `opt_state_from_jax`)}."""
    path = name if os.path.isfile(name) else ckpt_path(logdir, name)
    with open(path, "rb") as f:
        return _NumpyOnlyUnpickler(f).load()
