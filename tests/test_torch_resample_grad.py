"""Port vs JAX package: gradients of the all-bone grid resample (kernel K3's
plain version and the Python around the kernel).

The JAX side is `pallas_resample.resample_all_bones(..., windowed=False,
support_skip=False)`, whose backward runs the Pallas kernel in interpret
mode; the port is `resample_all_bones` on CPU tensors, whose backward is
autograd through `resample_bone_weights`. Compared: d(vols), dA, dT, and
parameter-side gradients through a softmax against the JAX default
(`support_skip=True`, exact only through the softmax). float32: 1e-4 of each
gradient's largest entry. bfloat16: relative L2 <= 5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humannerf_tpu.ops import pallas_resample
from humannerf_tpu_torch.ops import fused_warp as tfw

torch.set_num_threads(1)
K, D, G = 5, 8, 10
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(3)
    vols = rng.rand(K, D, D, D).astype(np.float32)
    Rs = []
    for _ in range(K):
        a = rng.uniform(-0.3, 0.3)
        c, s = np.cos(a), np.sin(a)
        Rs.append(np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
                  * rng.uniform(0.8, 1.2))
    Rs = np.stack(Rs).astype(np.float32)
    Ts = rng.uniform(-0.2, 0.2, (K, 3)).astype(np.float32)
    boxes = (np.array([-1.0, -1.1, -0.9], np.float32),      # cnl min
             np.array([1.0, 0.9, 1.1], np.float32),         # cnl scale
             np.array([-1.2, -1.2, -1.2], np.float32),      # obs min
             np.array([1.2, 1.3, 1.1], np.float32))         # obs max
    cot = rng.randn(G ** 3, K).astype(np.float32)
    cot[rng.rand(G ** 3) < 0.4] = 0.0                        # untouched voxels
    return vols, Rs, Ts, boxes, cot


def _jax_grads(vols, Rs, Ts, boxes, cot, dtype, **kw):
    def loss(v, R, T):
        w = pallas_resample.resample_all_bones(
            v, R, T, *[jnp.asarray(b) for b in boxes], G, dtype=dtype,
            blk=128, **kw)
        return jnp.sum(w * cot), w
    (_, w), g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(vols), jnp.asarray(Rs), jnp.asarray(Ts))
    return np.asarray(w), [np.asarray(x) for x in g]


def _torch_grads(vols, Rs, Ts, boxes, cot, dtype, fn=None):
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True)
              for a in (vols, Rs, Ts)]
    fn = fn or tfw.resample_all_bones
    w = fn(*leaves, *[torch.from_numpy(b) for b in boxes], G, dtype)
    (w * torch.from_numpy(cot)).sum().backward()
    return w.detach().numpy(), [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("dtype", list(DT))
def test_gradients_match_pallas_interpret(setup, dtype):
    vols, Rs, Ts, boxes, cot = setup
    jdt, tdt = DT[dtype]
    jw, jg = _jax_grads(vols, Rs, Ts, boxes, cot, jdt, windowed=False,
                        support_skip=False)
    tw, tg = _torch_grads(vols, Rs, Ts, boxes, cot, tdt)
    assert tw.shape == (G ** 3, K)
    for name, a, b in zip(("d_vols", "dA", "dT"), tg, jg):
        assert a.shape == b.shape and a.dtype == np.float32, name
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-4 * np.abs(b).max(),
                                       err_msg=name)
        else:
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert rel <= 5e-2, (name, rel)
    if dtype == "float32":
        np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(tw, jw, rtol=0, atol=2e-2)


def test_function_equals_autograd_of_the_plain_version(setup):
    vols, Rs, Ts, boxes, cot = setup
    for tdt in (torch.float32, torch.bfloat16):
        w1, g1 = _torch_grads(vols, Rs, Ts, boxes, cot, tdt)
        w2, g2 = _torch_grads(vols, Rs, Ts, boxes, cot, tdt,
                              fn=tfw.resample_all_bones_plain)
        np.testing.assert_array_equal(w1, w2)
        for a, b in zip(g1, g2):
            np.testing.assert_array_equal(a, b)


def test_parameter_gradients_through_the_softmax_match_the_default(setup):
    """vols = softmax(logits + log prior) with zero-prior voxels: the JAX
    default (support skip, windows where they fit) is exact there, and the
    port, which skips only zero cotangents, gives the same logit gradients."""
    vols, Rs, Ts, boxes, cot = setup
    rng = np.random.RandomState(4)
    logits = rng.randn(K + 1, D, D, D).astype(np.float32)
    prior = rng.rand(K + 1, D, D, D).astype(np.float32)
    prior[:K, :, :, : D // 2] = 0.0          # bones supported on one half
    prior[K] = 0.5

    def jloss(lg):
        v = jax.nn.softmax(lg + jnp.log(jnp.asarray(prior)), axis=0)[:K]
        w = pallas_resample.resample_all_bones(
            v, jnp.asarray(Rs), jnp.asarray(Ts),
            *[jnp.asarray(b) for b in boxes], G, dtype=jnp.float32, blk=128)
        return jnp.sum(w * cot)
    ref = np.asarray(jax.grad(jloss)(jnp.asarray(logits)))
    lg = torch.from_numpy(logits.copy()).requires_grad_(True)
    v = torch.softmax(lg + torch.log(torch.from_numpy(prior)), dim=0)[:K]
    w = tfw.resample_all_bones(v, torch.from_numpy(Rs), torch.from_numpy(Ts),
                               *[torch.from_numpy(b) for b in boxes], G,
                               torch.float32)
    (w * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(lg.grad.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    assert np.abs(ref).max() > 0


def test_build_fused_volume_routes(setup):
    """pallas_resample chooses the route; the forward is the same."""
    vols, Rs, Ts, boxes, _ = setup
    args = [torch.from_numpy(a) for a in (vols, Rs, Ts, *boxes)]
    a = tfw.build_fused_volume(*args, G, dtype=torch.float32)
    b = tfw.build_fused_volume(*args, G, dtype=torch.float32,
                               pallas_resample=True)
    assert a.shape == (G, G, G, 16) and torch.equal(a, b)
    axes = tfw.obs_axes(args[5], args[6], G)
    grid = tfw.make_obs_grid(args[5], args[6], G)
    assert torch.equal(grid.reshape(G, G, G, 3)[2, 3, 4],
                       torch.stack([axes[0, 4], axes[1, 3], axes[2, 2]]))


def test_resample_wrapper_refuses_cpu_tensors(setup):
    vols, Rs, Ts, boxes, cot = setup
    with pytest.raises(ValueError, match="CUDA"):
        tfw.resample_backward(*[torch.from_numpy(a) for a in
                                (vols, Rs, Ts, *boxes)], G, torch.float32,
                              torch.from_numpy(cot))
