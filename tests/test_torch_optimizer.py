"""Port vs JAX package: train/optimizer.py. Labels, the decay schedule, and
three Adam steps against optax with the same gradients (float32, 1e-6
absolute on parameters of magnitude ~1: both are the textbook update)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humannerf_tpu.config import make_cfg as jmake
from humannerf_tpu.train import optimizer as jopt
from humannerf_tpu_torch.config import make_cfg as tmake
from humannerf_tpu_torch.train import optimizer as topt

torch.set_num_threads(1)
OPTS = ["train.lrate_decay", "1"]       # decay visible within a few steps


def _params(rng):
    def lin(i, o):
        return {"w": rng.randn(i, o).astype(np.float32),
                "b": rng.randn(o).astype(np.float32)}
    return {"cnl_mlp": {"pts_linears": [lin(5, 4), lin(4, 4)],
                        "output": lin(4, 2)},
            "non_rigid_mlp": {"block_mlps": [lin(3, 4)], "output": lin(4, 3)},
            "pose_decoder": {"block_mlps": [lin(6, 4)], "output": lin(4, 6)},
            "mweight_vol_decoder": {"const_embedding": rng.randn(7)
                                    .astype(np.float32),
                                    "block_mlp": lin(7, 8)}}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(tree.copy()).requires_grad_(True)


def test_labels_and_names_match():
    jcfg, tcfg = jmake(opts=OPTS), tmake(opts=OPTS)
    assert topt.customized_lr_names(tcfg) == jopt.customized_lr_names(jcfg)
    p = _params(np.random.RandomState(0))
    jl = jopt.label_params(jcfg, p)
    tl = topt.label_params(tcfg, p)
    for mod in p:
        assert set(jax.tree.leaves(jl[mod])) == {tl[mod]}
    assert tl == {"cnl_mlp": "base", "non_rigid_mlp": "non_rigid_mlp",
                  "pose_decoder": "pose_decoder",
                  "mweight_vol_decoder": "mweight_vol_decoder"}


def test_tree_leaves_order_is_jax_tree_order():
    p = _params(np.random.RandomState(0))
    for a, b in zip(topt.tree_leaves(p), jax.tree.leaves(p)):
        assert a is b


@pytest.mark.parametrize("frozen", [(), ("pose_decoder",)])
def test_three_adam_steps_match_optax(frozen):
    jcfg, tcfg = jmake(opts=OPTS), tmake(opts=OPTS)
    rng = np.random.RandomState(1)
    p = _params(rng)
    grads = [jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32)
                          * 10 ** rng.uniform(-3, 1), p) for _ in range(3)]
    jp = jax.tree.map(jnp.asarray, p)
    tx, state = jopt.make_optimizer(jcfg, jp, frozen)
    tp = _to_torch(p)
    opt, sched, labels = topt.make_optimizer(tcfg, tp, frozen)
    assert all(labels[m] == "frozen" for m in frozen)
    for step, g in enumerate(grads):
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, updates)
        for t, gt in zip(topt.tree_leaves(tp), topt.tree_leaves(g)):
            t.grad = torch.from_numpy(gt.copy())
        # the rate of this update: base * 0.1 ** (step / 1000)
        for group in opt.param_groups:
            base = tcfg.train.lr if group["label"] == "base" \
                else tcfg.train[f"lr_{group['label']}"]
            assert group["lr"] == pytest.approx(
                base * 0.1 ** (step / 1000.0), rel=1e-12)
        opt.step()
        sched.step()
        for a, b in zip(topt.tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=0, atol=1e-6)
    for mod in frozen:                     # frozen modules never move
        for a, b in zip(topt.tree_leaves(tp[mod]), topt.tree_leaves(p[mod])):
            np.testing.assert_array_equal(a.detach().numpy(), b)
    moved = np.abs(tp["cnl_mlp"]["output"]["w"].detach().numpy()
                   - p["cnl_mlp"]["output"]["w"]).max()
    assert moved == pytest.approx(3 * tcfg.train.lr, rel=0.35)


def test_adam_hyperparameters():
    tcfg = tmake(opts=[])
    opt, sched, _ = topt.make_optimizer(
        tcfg, _to_torch(_params(np.random.RandomState(0))))
    assert isinstance(opt, torch.optim.Adam)
    assert isinstance(sched, torch.optim.lr_scheduler.LambdaLR)
    for g in opt.param_groups:
        assert g["betas"] == (0.9, 0.999) and g["eps"] == 1e-8
        assert g["weight_decay"] == 0
    assert {g["label"] for g in opt.param_groups} == {
        "base", "non_rigid_mlp", "pose_decoder", "mweight_vol_decoder"}
