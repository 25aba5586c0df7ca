"""Port vs JAX package: train/loss.py. Same numpy inputs through both;
float32 agreement to 1e-5 (mse, l1) and 1e-4 (lpips), gradients to 1e-4 of
their largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humannerf_tpu.models.lpips import init_lpips_params as jinit
from humannerf_tpu.train import loss as jloss
from humannerf_tpu_torch.models.lpips import init_lpips_params as tinit
from humannerf_tpu_torch.train import loss as tloss

torch.set_num_threads(1)
WEIGHTS = {"lpips": 1.0, "mse": 0.2, "l1": 0.0}


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    n, P, R = 2, 16, 300
    rgb = rng.rand(R, 3).astype(np.float32)
    idx = np.full((n, P, P), -1, np.int32)
    slots = rng.permutation(R)[:200]
    where = rng.permutation(n * P * P)[:200]
    idx.reshape(-1)[where] = slots
    bg = np.array([0.1, 0.4, 0.8], np.float32)
    targets = rng.rand(n, P, P, 3).astype(np.float32)
    return rgb, idx, bg, targets


def test_gather_patch_images(data):
    rgb, idx, bg, _ = data
    ref = np.asarray(jloss.gather_patch_images(
        jnp.asarray(rgb), jnp.asarray(idx), jnp.asarray(bg)))
    out = tloss.gather_patch_images(torch.from_numpy(rgb),
                                    torch.from_numpy(idx),
                                    torch.from_numpy(bg)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out[idx < 0] == bg).all()
    small = tloss.gather_patch_images(
        torch.arange(12.0).reshape(4, 3),
        torch.tensor([[[0, 1], [-1, 3]]]), torch.full((3,), 9.0)).numpy()
    np.testing.assert_array_equal(small[0, 1], [[9, 9, 9], [9, 10, 11]])


@pytest.mark.parametrize("names", [("mse",), ("mse", "l1"),
                                   ("lpips", "mse")])
def test_image_losses_and_total(data, names):
    rgb, idx, bg, targets = data
    jlp = jinit(None) if "lpips" in names else None
    tlp = tinit(None) if "lpips" in names else None

    def jtotal(r):
        patches = jloss.gather_patch_images(r, jnp.asarray(idx),
                                            jnp.asarray(bg))
        losses = jloss.image_losses(patches, jnp.asarray(targets), names, jlp)
        return jloss.total_loss(losses, WEIGHTS)
    (jt, jterms), jgrad = jax.value_and_grad(jtotal, has_aux=True)(
        jnp.asarray(rgb))
    r = torch.from_numpy(rgb.copy()).requires_grad_(True)
    patches = tloss.gather_patch_images(r, torch.from_numpy(idx),
                                        torch.from_numpy(bg))
    losses = tloss.image_losses(patches, torch.from_numpy(targets), names,
                                tlp)
    total, terms = tloss.total_loss(losses, WEIGHTS)
    # weight-0 and missing terms are left out, in the weights' key order
    assert list(terms) == [k for k in WEIGHTS
                           if WEIGHTS[k] > 0 and k in names] == list(jterms)
    for k in terms:
        np.testing.assert_allclose(float(terms[k]), float(jterms[k]),
                                   rtol=1e-4 if k == "lpips" else 1e-5)
    np.testing.assert_allclose(float(total), float(jt), rtol=1e-4)
    total.backward()
    g = np.asarray(jgrad)
    np.testing.assert_allclose(r.grad.numpy(), g, rtol=0,
                               atol=1e-4 * np.abs(g).max())
    untouched = np.setdiff1d(np.arange(rgb.shape[0]), idx[idx >= 0])
    assert np.abs(r.grad.numpy()[untouched]).max() == 0


def test_multihead_losses_are_not_ported():
    assert not hasattr(tloss, "argmin_multihead_loss")
    assert not hasattr(tloss, "ssim_jax")
