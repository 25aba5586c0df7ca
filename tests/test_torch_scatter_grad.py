"""Port vs JAX package: gradients of the packed-volume sample gather (kernel
K4's plain version and the Python around the kernel).

The JAX side is `pallas_scatter.sample_packed_grad`, whose backward runs the
Pallas scatter kernel in interpret mode; the port is `sample_packed_grad` on
CPU tensors, whose backward is autograd through `sample_packed_volume`.
float32: 1e-4 of each gradient's largest entry (summation order). bfloat16
volume: relative L2 <= 5e-2 (the JAX kernel rounds cotangent and corner
weights to bf16 before multiplying; the port multiplies in float32 and
rounds dU once, to the volume's dtype).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humannerf_tpu.ops import pallas_scatter
from humannerf_tpu_torch.ops import fused_warp as tfw

torch.set_num_threads(1)
G = 10
N = 600
BLK, WIN = 128, 64


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    U = rng.randn(G, G, G, 16).astype(np.float32)
    U[..., 13:] = 0.0
    U[..., 12] = np.abs(U[..., 12]) + 0.2          # S > clamp
    # out-of-range points (validity path) and exact voxel-corner hits
    pts = rng.uniform(-1.45, 1.45, (N, 3)).astype(np.float32)
    pts[:32] = np.round(pts[:32] * 4) / 4
    omin = np.array([-1.2, -1.2, -1.2], np.float32)
    omax = np.array([1.2, 1.25, 1.15], np.float32)
    cot = rng.randn(N, 3).astype(np.float32)
    cot_s = rng.randn(N, 1).astype(np.float32)
    live = (rng.rand(N) > 0.3)
    return U, pts, omin, omax, cot, cot_s, live


def _jax_grads(U, pts, omin, omax, cot, cot_s, live, dtype):
    def loss(U_, p_):
        x, s, _ = pallas_scatter.sample_packed_grad(
            U_.astype(dtype), p_, jnp.asarray(omin), jnp.asarray(omax),
            dtype=dtype, blk=BLK, window=WIN,
            live=None if live is None else jnp.asarray(live))
        return jnp.sum(x * cot) + jnp.sum(s * cot_s), (x, s)
    (_, (x, s)), (gU, gp) = jax.value_and_grad(loss, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(U), jnp.asarray(pts))
    return (np.asarray(x), np.asarray(s), np.asarray(gU, np.float32),
            np.asarray(gp))


def _torch_grads(U, pts, omin, omax, cot, cot_s, live, dtype, fn="grad"):
    Ut = torch.from_numpy(U.copy()).requires_grad_(True)
    pt = torch.from_numpy(pts.copy()).requires_grad_(True)
    lo, hi = torch.from_numpy(omin), torch.from_numpy(omax)
    lv = None if live is None else torch.from_numpy(live)
    Uc = Ut.to(dtype)
    Uc.retain_grad()
    if fn == "grad":
        x, s = tfw.sample_packed_grad(Uc, pt, lo, hi, live=lv)
    else:
        x, s = tfw.sample_packed_volume(tfw.build_packed_volume(Uc), pt, lo,
                                        hi, live=lv)
    ((x * torch.from_numpy(cot)).sum()
     + (s * torch.from_numpy(cot_s)).sum()).backward()
    return (x.detach().numpy(), s.detach().numpy(), Ut.grad.numpy(),
            pt.grad.numpy(), Uc.grad)


@pytest.mark.parametrize("masked", [False, True])
def test_float32_gradients_match_pallas_interpret(setup, masked):
    U, pts, omin, omax, cot, cot_s, live = setup
    lv = live if masked else None
    jx, js, jU, jp = _jax_grads(U, pts, omin, omax, cot, cot_s, lv,
                                jnp.float32)
    tx, ts, tU, tp, Uc_grad = _torch_grads(U, pts, omin, omax, cot, cot_s, lv,
                                           torch.float32)
    np.testing.assert_allclose(tx, jx, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tU, jU, rtol=0, atol=1e-4 * np.abs(jU).max())
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4 * np.abs(jp).max())
    assert Uc_grad.dtype == torch.float32
    # out-of-range and dead samples: no output, no gradient to their point
    f = (pts - omin) * ((G - 1) / (omax - omin))
    dead = ~((f >= 0) & (f <= G - 1)).all(axis=1)
    if masked:
        dead |= ~live
    assert dead.sum() > 50
    assert np.abs(ts[dead]).max() == 0 and np.abs(tp[dead]).max() == 0
    assert np.abs(tp[~dead]).max() > 0


def test_bfloat16_volume_gradients(setup):
    U, pts, omin, omax, cot, cot_s, live = setup
    _, _, jU, jp = _jax_grads(U, pts, omin, omax, cot, cot_s, live,
                              jnp.bfloat16)
    _, _, tU, tp, Uc_grad = _torch_grads(U, pts, omin, omax, cot, cot_s, live,
                                         torch.bfloat16)
    # dU in the volume's dtype, not float32
    assert Uc_grad.dtype == torch.bfloat16
    assert np.linalg.norm(tU - jU) / np.linalg.norm(jU) <= 5e-2
    assert np.linalg.norm(tp - jp) / np.linalg.norm(jp) <= 5e-2
    _, _, fU, fp, _ = _torch_grads(U, pts, omin, omax, cot, cot_s, live,
                                   torch.float32)
    assert np.linalg.norm(tU - fU) / np.linalg.norm(fU) <= 5e-2


def test_function_equals_autograd_of_the_plain_version(setup):
    U, pts, omin, omax, cot, cot_s, live = setup
    a = _torch_grads(U, pts, omin, omax, cot, cot_s, live, torch.float32)
    b = _torch_grads(U, pts, omin, omax, cot, cot_s, live, torch.float32,
                     fn="plain")
    for x, y in zip(a[:4], b[:4]):
        np.testing.assert_array_equal(x, y)


def test_closed_form_d_pts_and_scatter_inputs(setup):
    """What the CUDA route computes outside the kernel: d(pts) in closed
    form, and the kernel's inputs reproduce dU when summed by hand."""
    U, pts, omin, omax, cot, cot_s, live = setup
    Ut = torch.from_numpy(U)
    pt = torch.from_numpy(pts.copy()).requires_grad_(True)
    lo, hi = torch.from_numpy(omin), torch.from_numpy(omax)
    U8 = tfw.build_packed_volume(Ut)
    acc, (flat, w3, valid, scale) = tfw.packed_acc(U8, pt, lo, hi,
                                                   torch.from_numpy(live))
    d_acc = torch.from_numpy(np.random.RandomState(5).randn(N, 16)
                             .astype(np.float32))
    ref_pts, = torch.autograd.grad(acc, [pt], d_acc)
    d_accm = torch.where(valid[:, None], d_acc, torch.zeros_like(d_acc))
    g8 = U8.reshape(G ** 3, 128)[flat].reshape(-1, 8, 16)
    # the cotangent as the step hands it, whatever an invalid row holds
    d_raw = torch.where(valid[:, None], d_acc, torch.full_like(d_acc, np.nan))
    got = tfw.d_pts_closed_form(g8, w3.detach(), d_raw, valid, scale)
    np.testing.assert_allclose(got.numpy(), ref_pts.numpy(), rtol=0,
                               atol=1e-4 * float(ref_pts.abs().max()))
    # the kernel's sum, by hand: eight weighted corner rows per valid sample
    Ul = Ut.clone().requires_grad_(True)
    acc2, _ = tfw.packed_acc(tfw.build_packed_volume(Ul), pt.detach(), lo, hi,
                             torch.from_numpy(live))
    ref_U, = torch.autograd.grad(acc2, [Ul], d_acc)
    k8 = torch.arange(8)
    off = ((k8 >> 2) * G + ((k8 >> 1) & 1)) * G + (k8 & 1)
    idx = (flat[:, None] + off[None, :]).reshape(-1)
    src = (tfw._corner_weights(w3.detach())[:, :, None]
           * d_accm[:, None, :]).reshape(-1, 16)
    dU = torch.zeros(G ** 3, 16).index_add_(0, idx, src)
    np.testing.assert_allclose(dU.reshape(G, G, G, 16).numpy(),
                               ref_U.numpy(), rtol=0,
                               atol=1e-5 * float(ref_U.abs().max()))
    assert int(idx.max()) < G ** 3          # base corner clipped to G - 2


def test_scatter_wrapper_refuses_cpu_tensors_and_bad_volume(setup):
    U, pts, omin, omax, *_ = setup
    with pytest.raises(ValueError, match="CUDA"):
        tfw.scatter_grad_volume(torch.zeros(4, dtype=torch.int64),
                                torch.zeros(4, 3),
                                torch.zeros(4, dtype=torch.bool),
                                torch.zeros(4, 16), G)
    with pytest.raises(ValueError, match="16 channels"):
        tfw.sample_packed_grad(torch.zeros(G, G, G, 40),
                               torch.from_numpy(pts), torch.from_numpy(omin),
                               torch.from_numpy(omax))
