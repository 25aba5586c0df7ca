"""Port vs JAX package: gradients of the fused MLP query (kernel K2's plain
version and the Python around the kernel).

The JAX side differentiates its Pallas kernels in interpret mode
(`query_points_fused_t` with dead blocks, `query_points_fused` for ragged
N); the port differentiates `query_points_fused` on CPU tensors, which is
autograd through `query_points_plain`. Compared: dx, every dW and db, and
the condition code's gradient.

Tolerances. float32: 1e-4 of each tensor's largest entry (the two sum the
same products in another order). bfloat16: relative L2 error per tensor
<= 5e-2 against the JAX kernel (measured: <= 2.1e-2): the two round at
different places (the JAX kernel rounds dy before each product, autograd
rounds the gradient at each cast), so single entries differ by a bf16 ulp of
the largest term. Against the port's own float32 gradients the limit is
0.25: bf16 rounding of the offset is amplified by the canonical embedding's
top frequency (2^9), and the JAX package's bf16 gradients are just as far
(7-15 %) from its float32 ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humannerf_tpu.ops import pallas_mlp
from humannerf_tpu_torch.models import mlps as tmlps
from humannerf_tpu_torch.ops import fused_mlp

from torch_port_util import np_like, to_jax, to_torch

torch.set_num_threads(1)
NR = dict(depth=3, width=16, multires=6, skips=(2,))
CNL = dict(depth=4, width=32, multires=10)
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ALPHA = 4.3
LIVE = np.array([1, 0, 1, 1], np.int32)                 # 4 tiles of 128


def _plans(dtype, skip_nr=False):
    jdt, tdt = DT[dtype]
    kw = dict(nr_depth=NR["depth"], nr_skips=NR["skips"],
              nr_width=NR["width"], nr_multires=NR["multires"],
              cnl_depth=CNL["depth"], cnl_skips=(1,), cnl_width=CNL["width"],
              cnl_multires=CNL["multires"], skip_nr=skip_nr)
    jp = pallas_mlp.Plan(compute_dtype=jdt, **kw)
    pallas_mlp.register_plan(jp)
    return jp, fused_mlp.Plan(compute_dtype=tdt, **kw)


@pytest.fixture(scope="module")
def setup():
    gen = torch.Generator().manual_seed(0)
    tmpl = {
        "non_rigid_mlp": tmlps.init_nonrigid_mlp(
            gen, pos_embed_size=36, mlp_width=NR["width"],
            mlp_depth=NR["depth"], skips=NR["skips"]),
        "cnl_mlp": tmlps.init_canonical_mlp(
            gen, input_ch=63, mlp_depth=CNL["depth"], mlp_width=CNL["width"],
            skips=(1,)),
    }
    p = np_like(tmpl, 21)
    p["non_rigid_mlp"]["output"]["w"] *= 0.05
    p["non_rigid_mlp"]["output"]["b"] *= 0.05
    rng = np.random.RandomState(22)
    x = (rng.randn(512, 3) * 0.5).astype(np.float32)
    cc = (rng.randn(69) * 0.1).astype(np.float32)
    g = rng.randn(512, 4).astype(np.float32)
    return p, x, cc, g


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}" if prefix else k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}[{i}]"))
    else:
        out[prefix] = np.asarray(tree)
    return out


def _jax_grads(jp, p, x, cc, g, live, n=None):
    """Gradients of sum(raw * g) through the JAX package's kernels."""
    def loss(params, xx, c):
        if live is None:
            raw = pallas_mlp.query_points_fused(
                jp, params, xx, jnp.asarray(ALPHA), c, blk_fwd=128,
                blk_bwd=128)
        else:
            raw = pallas_mlp.query_points_fused_t(
                jp, params, xx.T, jnp.asarray(ALPHA), c, jnp.asarray(live),
                jnp.asarray(live), 128, 128).T
        return jnp.sum(raw * jnp.asarray(g[:n]))
    gp, gx, gc = jax.grad(loss, argnums=(0, 1, 2))(
        to_jax(p), jnp.asarray(x[:n]), jnp.asarray(cc))
    out = _flat(gp)
    out["dx"], out["condition_code"] = np.asarray(gx), np.asarray(gc)
    return out


def _torch_grads(tp, p, x, cc, g, live, n=None):
    params = to_torch(p)
    leaves = []

    def req(t):
        t.requires_grad_(True)
        leaves.append(t)
        return t
    params = {k: _map(req, v) for k, v in params.items()}
    xt = torch.from_numpy(x[:n].copy()).requires_grad_(True)
    ct = torch.from_numpy(cc.copy()).requires_grad_(True)
    raw = fused_mlp.query_points_fused(
        tp, params, xt, ALPHA, ct,
        None if live is None else torch.from_numpy(live))
    (raw * torch.from_numpy(g[:n])).sum().backward()
    out = {k: (np.zeros(v.shape, np.float32) if v.grad is None
               else v.grad.numpy()) for k, v in _flat_t(params).items()}
    out["dx"] = xt.grad.numpy()
    out["condition_code"] = np.zeros_like(cc) if ct.grad is None \
        else ct.grad.numpy()
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _flat_t(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_t(v, f"{prefix}.{k}" if prefix else k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat_t(v, f"{prefix}[{i}]"))
    else:
        out[prefix] = tree
    return out


def _check(dtype, got, ref, f32=None):
    assert set(got) == set(ref)
    for k in ref:
        a, b = got[k], np.asarray(ref[k], np.float32)
        assert a.shape == b.shape, k
        scale = np.abs(b).max()
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * scale + 1e-9,
                                       err_msg=k)
        else:
            if scale == 0:
                assert np.abs(a).max() == 0, k
                continue
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert rel <= 5e-2, (k, rel)
            if f32 is not None:
                r32 = np.linalg.norm(a - f32[k]) / np.linalg.norm(f32[k])
                assert r32 <= 0.25, (k, r32)


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("skip_nr", [False, True])
def test_gradients_match_pallas_interpret_with_dead_tiles(setup, dtype,
                                                          skip_nr):
    p, x, cc, g = setup
    jp, tp = _plans(dtype, skip_nr)
    ref = _jax_grads(jp, p, x, cc, g, LIVE)
    got = _torch_grads(tp, p, x, cc, g, LIVE)
    f32 = None
    if dtype == "bfloat16":
        f32 = _torch_grads(_plans("float32", skip_nr)[1], p, x, cc, g, LIVE)
    _check(dtype, got, ref, f32)
    # a dead tile's samples get exactly zero dx
    assert np.abs(got["dx"][128:256]).max() == 0
    assert np.abs(np.asarray(ref["dx"])[128:256]).max() == 0
    assert np.abs(got["dx"][:128]).max() > 0
    if skip_nr:
        assert np.abs(got["condition_code"]).max() == 0
        assert all(np.abs(v).max() == 0 for k, v in got.items()
                   if k.startswith("non_rigid_mlp"))
    else:
        assert np.abs(got["condition_code"]).max() > 0
        assert np.abs(got["non_rigid_mlp.block_mlps[0].w"][:69]).max() > 0


@pytest.mark.parametrize("dtype", list(DT))
def test_gradients_match_pallas_interpret_ragged_n(setup, dtype):
    p, x, cc, g = setup
    jp, tp = _plans(dtype)
    n = 300
    ref = _jax_grads(jp, p, x, cc, g, None, n=n)
    got = _torch_grads(tp, p, x, cc, g, None, n=n)
    assert got["dx"].shape == (n, 3)
    _check(dtype, got, ref)


def test_gradient_shapes_and_dtypes_are_the_parameters(setup):
    p, x, cc, g = setup
    _, tp = _plans("bfloat16")
    got = _torch_grads(tp, p, x, cc, g, LIVE)
    for k, v in _flat(p).items():
        assert got[k].shape == v.shape and got[k].dtype == np.float32, k


def test_hann_window_is_float32_and_its_jacobian_matches(setup):
    """The window weights scale the non-rigid embedding's Jacobian in
    training: they are the JAX package's float32 numbers (to an ulp of the
    cosine), and dx with a partly open window agrees."""
    from humannerf_tpu.models import embedders as jemb
    from humannerf_tpu_torch.models import embedders as temb
    for alpha in (0.0, 0.37, 2.5, 4.3, 6.0, 9.0):
        tw = np.asarray(temb.hann_window_weights(alpha, 6))
        jw = np.asarray(jemb.hann_window_weights(jnp.asarray(alpha,
                                                             jnp.float32), 6))
        assert all(float(np.float32(v)) == v for v in tw)   # exact float32
        np.testing.assert_allclose(tw, jw, rtol=0, atol=2.5e-7)
    p, x, cc, g = setup
    jp, tp = _plans("float32")

    def jloss(xx):
        return jnp.sum(pallas_mlp.query_points_fused(
            jp, to_jax(p), xx, jnp.asarray(2.5), jnp.asarray(cc),
            blk_fwd=128, blk_bwd=128) * jnp.asarray(g[:256]))
    ref = np.asarray(jax.grad(jloss)(jnp.asarray(x[:256])))
    xt = torch.from_numpy(x[:256].copy()).requires_grad_(True)
    raw = fused_mlp.query_points_fused(tp, to_torch(p), xt, 2.5,
                                       torch.from_numpy(cc))
    (raw * torch.from_numpy(g[:256])).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_kernel_operands_are_differentiable_views(setup):
    """The autograd function of the CUDA route takes `kernel_operands`: the
    gradient of a parameter's other parts (the condition-code rows of the
    first non-rigid layer) and of the condition code follows from the fold,
    outside the kernel."""
    p, _, cc, _ = setup
    _, tp = _plans("float32")
    params = _map(lambda t: t.requires_grad_(True), to_torch(p))
    ct = torch.from_numpy(cc.copy()).requires_grad_(True)
    ops = fused_mlp.kernel_operands(tp, params["non_rigid_mlp"],
                                    params["cnl_mlp"], ct)
    slots, flat = fused_mlp._flatten_operands(ops)
    assert len(flat) == tp.n_tensors()
    assert [s for s in slots if s[0] == "nr"][:2] == [("nr", "w_e", 0),
                                                      ("nr", "b", 0)]
    assert tuple(ops["nr"]["w_e"][0].shape) == (36, 16)      # unpadded
    assert ops["cnl"]["w_e"][2].shape == (63, 32) and \
        ops["cnl"]["w_e"][1] is None
    ops["nr"]["b"][0].sum().backward()
    w0 = params["non_rigid_mlp"]["block_mlps"][0]["w"]
    np.testing.assert_allclose(w0.grad[:69].numpy(),
                               np.repeat(cc[:, None], 16, axis=1), atol=1e-7)
    assert float(w0.grad[69:].abs().max()) == 0
    np.testing.assert_allclose(ct.grad.numpy(),
                               w0.detach()[:69].sum(dim=1).numpy(), atol=1e-6)
    nets = fused_mlp.pack_kernel_weights(tp, ops, backward=True)
    assert tuple(nets["nr"]["w_e_t"][0].shape) == (16, 48)   # (out, epad)
    assert tuple(nets["cnl"]["w_h_t"][1].shape) == (32, 32)
    assert torch.equal(nets["cnl"]["w_h_t"][1],
                       params["cnl_mlp"]["pts_linears"][1]["w"].detach().t())
    # bfloat16 reads the chunks transposed: no (out, in) copies
    _, tp16 = _plans("bfloat16")
    nets16 = fused_mlp.pack_kernel_weights(tp16, ops, backward=True)
    assert nets16["cnl"]["w_h_t"] == [None] * 4
    assert nets16["nr"]["w_e_t"] == [None] * 3
    assert tuple(nets16["nr"]["w_e"][0].shape) == (1, 16, 64)
    assert tuple(nets16["cnl"]["w_h"][1].shape) == (1, 32, 64)
    g = fused_mlp._grad_buffers(nets["cnl"], "cpu")
    assert tuple(g["w_e"][0].shape) == (64, 32) and g["w_h"][0] is None
    assert all(t.data_ptr() % 32 == 0 for t in g["b"])
