"""Port vs JAX package: LPIPS (models/lpips.py). The random trunk is drawn
with numpy from the same seed in both packages, so the weights are the same
numbers; distances and their gradients agree to float32 summation order
(1e-4 relative, 13 stacked convolutions)."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humannerf_tpu.models import lpips as jlp
from humannerf_tpu_torch.models import lpips as tlp

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def both():
    return jlp.init_lpips_params(None), tlp.init_lpips_params(None)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def test_random_trunk_and_lin_heads_are_the_same_numbers(both):
    jp, tp = both
    jl, tl = _leaves(jp), _leaves(tp)
    assert len(jl) == len(tl) == 13 * 2 + 5
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(a, b)
    assert tlp.lpips_trunk_kind(None) == tlp.lpips_trunk_kind("empty") \
        == jlp.lpips_trunk_kind("empty") == "random"


def test_lin_head_asset_is_the_ports_own_copy():
    mine = os.path.join(REPO, "humannerf_tpu_torch", "assets",
                        "lpips_v01_vgg_lins.pkl")
    theirs = os.path.join(REPO, "humannerf_tpu", "assets",
                          "lpips_v01_vgg_lins.pkl")
    assert tlp._ASSET == mine and os.path.isfile(mine)
    assert open(mine, "rb").read() == open(theirs, "rb").read()


@pytest.mark.parametrize("size", [32, 8])
def test_distance_and_gradient_match(both, size):
    jp, tp = both
    rng = np.random.RandomState(size)
    a = rng.uniform(-1, 1, (2, 3, size, size)).astype(np.float32)
    b = np.clip(a + 0.3 * rng.randn(*a.shape), -1, 1).astype(np.float32)
    ref = np.asarray(jlp.lpips_distance(jp, jnp.asarray(a), jnp.asarray(b)))
    ta = torch.from_numpy(a).requires_grad_(True)
    out = tlp.lpips_distance(tp, ta, torch.from_numpy(b))
    assert out.shape == (2,)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-4)
    gref = np.asarray(jax.grad(lambda x: jnp.sum(
        jlp.lpips_distance(jp, x, jnp.asarray(b))))(jnp.asarray(a)))
    out.sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), gref, rtol=0,
                               atol=1e-4 * np.abs(gref).max())
    # an 8 x 8 patch stops before the pools would empty the map
    n_feats = len(tlp.vgg_features(tp, torch.from_numpy(a)))
    assert n_feats == len(jlp.vgg_features(jp, jnp.asarray(a))) \
        == (5 if size == 32 else 4)


def test_layers_and_no_lins_options(both):
    jp, tp = both
    rng = np.random.RandomState(1)
    a = rng.uniform(-1, 1, (1, 3, 16, 16)).astype(np.float32)
    b = rng.uniform(-1, 1, (1, 3, 16, 16)).astype(np.float32)
    for kw in (dict(layers=(0, 2)), dict(use_lins=False)):
        ref = np.asarray(jlp.lpips_distance(jp, jnp.asarray(a),
                                            jnp.asarray(b), **kw))
        out = tlp.lpips_distance(tp, torch.from_numpy(a),
                                 torch.from_numpy(b), **kw).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-4)


def test_metric_fn_and_converted_weights(both, tmp_path):
    jp, tp = both
    rng = np.random.RandomState(2)
    pred = rng.rand(16, 16, 3).astype(np.float32)
    truth = rng.rand(16, 16, 3).astype(np.float32)
    ref = jlp.make_lpips_metric_fn(jp)(pred, truth)
    got = tlp.make_lpips_metric_fn(tp)(pred, truth)
    assert got == pytest.approx(ref, rel=1e-4)
    np.testing.assert_array_equal(
        tlp.scale_for_lpips(torch.tensor([0.0, 0.5, 1.0])).numpy(),
        [-1.0, 0.0, 1.0])
    # a converted-weights pickle (the JAX package's layout) loads in both
    path = str(tmp_path / "vgg.pkl")
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(lambda x: np.asarray(x) * 0.5, jp), f)
    assert tlp.lpips_trunk_kind(path) == "converted"
    t2 = tlp.init_lpips_params(path)
    j2 = jlp.init_lpips_params(path)
    for x, y in zip(_leaves(j2), _leaves(t2)):
        np.testing.assert_array_equal(x, y)
    t3 = tlp.lpips_params_from_jax(jax.tree.map(np.asarray, jp))
    assert t3["features"][0][0]["w"].dtype == torch.float32
