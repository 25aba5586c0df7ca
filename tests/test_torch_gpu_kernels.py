"""The hand-written CUDA kernels against their plain versions, on the card.

Marked `gpu`: every test here needs a CUDA device and nvcc and skips without
one (`python -m pytest tests/test_torch_gpu_kernels.py -m gpu` on a machine
with an H100). Covers what `chip_smoke.py` does not drive: every width the
fused MLP kernel is instantiated for (64, 128, 192, 256), shallow and deep
nets, tile-liveness patterns of the persistent grid (every tile dead, fewer
live tiles than SMs, one live tile at the ragged end), sample counts other
than 128 in the compositor, and the wrappers'
refusals on CUDA tensors; the three backward kernels (fused MLP,
resample, scatter) against autograd through their plain versions at the same
widths, small volumes and grids, with dead tiles, ragged sizes and masks; and
the packed-volume gather + trilerp kernel at G = 24 and 48 with a live mask,
all samples dead, a ragged N and points out of range.
"""

import numpy as np
import pytest
import torch

from humannerf_tpu_torch.models import mlps
from humannerf_tpu_torch.ops import composite, fused_mlp, fused_warp, trilerp
from humannerf_tpu_torch.ops.raymarch import raw2outputs
from humannerf_tpu_torch.utils.tree import flat_grads, leafify, rel_l2

pytestmark = pytest.mark.gpu

# kernel vs plain version: f32 differs by summation order only; in bf16 a
# summation-order difference can flip the bf16 rounding of an activation,
# which the canonical embedding's top frequency amplifies
TOL = {torch.float32: 5e-4, torch.bfloat16: 8e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from humannerf_tpu_torch import runtime
    return runtime.setup()


def _setup(dev, nr_width, cnl_width, nr_depth, cnl_depth, dtype, skip_nr,
           nr_multires=6, cnl_multires=10, cnl_skips=(1,)):
    plan = fused_mlp.Plan(
        nr_depth=nr_depth, nr_skips=(2,), nr_width=nr_width,
        nr_multires=nr_multires, cnl_depth=cnl_depth, cnl_skips=cnl_skips,
        cnl_width=cnl_width, cnl_multires=cnl_multires, skip_nr=skip_nr,
        compute_dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    params = {
        "non_rigid_mlp": mlps.init_nonrigid_mlp(
            gen, pos_embed_size=6 * nr_multires, mlp_width=nr_width,
            mlp_depth=nr_depth, skips=(2,), device=dev),
        "cnl_mlp": mlps.init_canonical_mlp(
            gen, input_ch=3 + 6 * cnl_multires, mlp_depth=cnl_depth,
            mlp_width=cnl_width, skips=cnl_skips, device=dev),
    }
    params["non_rigid_mlp"]["output"]["w"] *= 1e2     # mm-sized offsets
    for net, key in (("non_rigid_mlp", "block_mlps"), ("cnl_mlp",
                                                       "pts_linears")):
        for layer in params[net][key]:                # biases matter too
            layer["b"] += 0.05 * torch.randn(layer["b"].shape,
                                             generator=gen).to(dev)
    x = (torch.randn((1000, 3), generator=gen) * 0.5).to(dev)
    cc = (torch.randn((69,), generator=gen) * 0.1).to(dev)
    return plan, params, x, cc


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("widths", [(64, 64), (128, 192), (128, 256),
                                    (192, 128)])
@pytest.mark.parametrize("skip_nr", [False, True])
def test_fused_mlp_kernel_matches_plain(dev, dtype, widths, skip_nr):
    plan, params, x, cc = _setup(dev, widths[0], widths[1], 3, 4, dtype,
                                 skip_nr)
    live = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.int32,
                        device=dev)                    # 1000 -> 8 tiles
    before = fused_mlp.launches
    out = fused_mlp.query_points_fused(plan, params, x, 4.3, cc, live)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    ref = fused_mlp.query_points_plain(plan, params, x, 4.3, cc, live)
    assert out.shape == (1000, 4) and bool(torch.isfinite(out).all())
    assert float(out[128:256].abs().max()) == 0.0      # dead tile
    assert float(out[:128].abs().max()) > 0.05
    assert float((out - ref).abs().max()) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_mlp_kernel_deepest_plan(dev, dtype):
    plan, params, x, cc = _setup(dev, 128, 256, 6, 12, dtype, False)
    out = fused_mlp.query_points_fused(plan, params, x, 6.0, cc)
    ref = fused_mlp.query_points_plain(plan, params, x, 6.0, cc)
    assert float((out - ref).abs().max()) <= TOL[dtype]


def test_fused_mlp_wrapper_refuses_on_cuda(dev):
    plan, params, x, cc = _setup(dev, 128, 256, 3, 4, torch.bfloat16, False)
    with pytest.raises(TypeError):
        fused_mlp.query_points_fused(plan, params, x.double(), 4.3, cc)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mlp.query_points_fused(plan, params, x.t().contiguous().t(),
                                     4.3, cc)
    with pytest.raises(ValueError, match="live"):
        fused_mlp.query_points_fused(
            plan, params, x, 4.3, cc,
            torch.ones(3, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="another device"):
        fused_mlp.query_points_fused(plan, params, x, 4.3, cc.cpu())
    narrow, p2, _, _ = _setup(dev, 128, 256, 3, 4, torch.bfloat16, False)
    narrow.cnl_width = 32
    with pytest.raises(ValueError, match="multiple of 64"):
        fused_mlp.query_points_fused(narrow, p2, x, 4.3, cc)


@pytest.mark.parametrize("shape", [(77, 16), (300, 40), (64, 128), (5, 200)])
def test_composite_kernel_matches_plain(dev, shape):
    R, S = shape
    rng = np.random.RandomState(1)
    raw = torch.from_numpy((rng.randn(R, S, 4) * 2).astype(np.float32)).to(dev)
    fg = rng.rand(R, S, 1).astype(np.float32)
    fg[fg < 0.5] = 0.0
    fg = torch.from_numpy(fg).to(dev)
    near = torch.from_numpy(rng.uniform(0.5, 1, R).astype(np.float32))
    z = (near[:, None] + torch.linspace(0, 1, S)[None] * 0.7).to(dev)
    rays_d = torch.from_numpy((rng.randn(R, 3) + 2).astype(np.float32)).to(dev)
    bg = torch.tensor([10.0, 60.0, 200.0], device=dev)
    before = composite.launches
    out = composite.composite(raw, fg, z, rays_d, bg)
    torch.cuda.synchronize()
    assert composite.launches == before + 1
    ref = raw2outputs(raw, fg, z, rays_d, bg)
    for k in ("rgb", "alpha", "depth"):
        assert out[k].shape == ref[k].shape
        # log-space prefix sum vs cumprod, float32
        assert float((out[k] - ref[k]).abs().max()) <= 1e-4, k


def test_composite_wrapper_refuses_on_cuda(dev):
    raw = torch.zeros((4, 8, 4), device=dev)
    fg = torch.zeros((4, 8, 1), device=dev)
    z = torch.zeros((4, 8), device=dev)
    d = torch.ones((4, 3), device=dev)
    bg = torch.zeros(3, device=dev)
    with pytest.raises(TypeError):
        composite.composite(raw.half(), fg, z, d, bg)
    with pytest.raises(ValueError, match="shape"):
        composite.composite(raw, fg[..., 0], z, d, bg)
    with pytest.raises(ValueError, match="contiguous"):
        composite.composite(raw, fg, z.t().contiguous().t(), d, bg)
    with pytest.raises(ValueError, match="expected"):
        composite.composite(raw, fg, z, d.cpu(), bg)


# ---------------------------------------------------------------------------
# backward kernels
# ---------------------------------------------------------------------------

# relative L2 per gradient tensor. float32: summation order (atomics) and,
# with the non-rigid net, relu units near zero that the two forwards mask
# differently; bfloat16: the kernel rounds dy before each product, autograd
# rounds the gradient at each cast
GRAD_TOL = {torch.float32: 1e-2, torch.bfloat16: 0.25}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("widths", [(64, 64), (128, 192), (128, 256),
                                    (192, 128)])
@pytest.mark.parametrize("skip_nr", [False, True])
def test_fused_mlp_backward_kernel_matches_autograd(dev, dtype, widths,
                                                    skip_nr):
    plan, params, x, cc = _setup(dev, widths[0], widths[1], 3, 4, dtype,
                                 skip_nr)
    params["non_rigid_mlp"]["output"]["w"] *= 1e-2     # initial offset scale
    live = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.int32,
                        device=dev)                    # 1000 -> 8 tiles
    g = torch.randn((1000, 4), generator=torch.Generator().manual_seed(1)
                    ).to(dev)

    def run(query):
        p = leafify(params)
        xl = x.clone().requires_grad_(True)
        cl = cc.clone().requires_grad_(True)
        query(plan, p, xl, 4.3, cl, live).backward(g)
        out = flat_grads(p)
        out["dx"] = xl.grad
        if cl.grad is not None:
            out["cc"] = cl.grad
        return out
    before = fused_mlp.bwd_launches
    gk = run(fused_mlp.query_points_fused)
    torch.cuda.synchronize()
    assert fused_mlp.bwd_launches == before + 1
    gp = run(fused_mlp.query_points_plain)
    gk = {k: v for k, v in gk.items() if k in gp}
    assert set(gk) == set(gp)
    assert float(gk["dx"][128:256].abs().max()) == 0.0      # dead tile
    assert float(gk["dx"][:128].abs().max()) > 0
    for k in gp:
        assert gk[k].shape == gp[k].shape and gk[k].dtype == gp[k].dtype
        assert bool(torch.isfinite(gk[k]).all())
        if float(gp[k].abs().max()) > 0:
            assert rel_l2(gk[k], gp[k]) <= GRAD_TOL[dtype], k


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_mlp_backward_kernel_deepest_plan_ragged(dev, dtype):
    plan, params, x, cc = _setup(dev, 128, 256, 6, 12, dtype, False)
    params["non_rigid_mlp"]["output"]["w"] *= 1e-2
    x = x[:777].contiguous()
    g = torch.randn((777, 4), generator=torch.Generator().manual_seed(2)
                    ).to(dev)

    def run(query):
        p = leafify(params)
        query(plan, p, x, 6.0, cc).backward(g)
        return flat_grads(p)
    gk, gp = run(fused_mlp.query_points_fused), \
        run(fused_mlp.query_points_plain)
    for k in gp:
        assert rel_l2(gk[k], gp[k]) <= 2 * GRAD_TOL[dtype], k


# embedding widths (multires -> padded to epad = 16, 32, 48, 64 columns) and
# two skip layers in the canonical net: the W_e products of both kernels,
# forward (h W + emb W_e), dE += dy W_e^T and dW_e, at every epad the
# float32 kernel's column groups take; a ragged last half-tile (n = 740)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("multires", [(2, 2), (4, 4), (6, 7), (10, 10)])
def test_fused_mlp_kernels_embedding_widths(dev, dtype, multires):
    plan, params, x, cc = _setup(dev, 128, 256, 4, 6, dtype, False,
                                 nr_multires=multires[0],
                                 cnl_multires=multires[1], cnl_skips=(1, 3))
    params["non_rigid_mlp"]["output"]["w"] *= 1e-2
    x = x[:740].contiguous()
    g = torch.randn((740, 4), generator=torch.Generator().manual_seed(3)
                    ).to(dev)

    def run(query):
        p = leafify(params)
        xl = x.clone().requires_grad_(True)
        out = query(plan, p, xl, 2.5, cc)
        out.backward(g)
        grads = flat_grads(p)
        grads["dx"] = xl.grad
        return out.detach(), grads
    out, gk = run(fused_mlp.query_points_fused)
    ref, gp = run(fused_mlp.query_points_plain)
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= TOL[dtype]
    for k in gp:
        assert bool(torch.isfinite(gk[k]).all()), k
        if float(gp[k].abs().max()) > 0:
            assert rel_l2(gk[k], gp[k]) <= GRAD_TOL[dtype], k


def _liveness_case(case, dev):
    """(n, live) for a tile pattern the persistent grid must handle."""
    if case == "all_dead":
        n = 4096
        live = torch.zeros(32, dtype=torch.int32)
    elif case == "few_live":             # fewer live tiles than SMs
        n = 64 * 128
        live = torch.zeros(64, dtype=torch.int32)
        live[[3, 17, 40, 41, 63]] = 1
    else:                                # one live tile, the ragged last
        n = 300 * 128 + 77
        live = torch.zeros(301, dtype=torch.int32)
        live[-1] = 1
    return n, live.to(dev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["all_dead", "few_live", "last_live"])
def test_fused_mlp_kernels_liveness_patterns(dev, dtype, case):
    plan, params, _, cc = _setup(dev, 128, 256, 3, 4, dtype, False)
    params["non_rigid_mlp"]["output"]["w"] *= 1e-2
    n, live = _liveness_case(case, dev)
    gen = torch.Generator().manual_seed(5)
    x = (torch.randn((n, 3), generator=gen) * 0.5).to(dev)
    g = torch.randn((n, 4), generator=gen).to(dev)
    alive = torch.repeat_interleave(live > 0, fused_mlp.TILE)[:n]

    def run(query):
        p = leafify(params)
        xl = x.clone().requires_grad_(True)
        out = query(plan, p, xl, 4.3, cc, live)
        out.backward(g)
        grads = flat_grads(p)
        grads["dx"] = xl.grad
        return out.detach(), grads
    before = (fused_mlp.launches, fused_mlp.bwd_launches)
    out, gk = run(fused_mlp.query_points_fused)
    torch.cuda.synchronize()
    assert (fused_mlp.launches, fused_mlp.bwd_launches) == \
        (before[0] + 1, before[1] + 1)
    ref, gp = run(fused_mlp.query_points_plain)
    assert out.shape == (n, 4) and bool(torch.isfinite(out).all())
    assert float(out[~alive].abs().max()) == 0.0
    assert float(gk["dx"][~alive].abs().max()) == 0.0
    if case == "all_dead":
        assert all(float(v.abs().max()) == 0.0 for v in gk.values())
        return
    assert float((out - ref).abs().max()) <= TOL[dtype]
    assert float(out[alive].abs().max()) > 0.05
    for k in gp:
        assert bool(torch.isfinite(gk[k]).all()), k
        if float(gp[k].abs().max()) > 0:
            assert rel_l2(gk[k], gp[k]) <= GRAD_TOL[dtype], k


def test_fused_mlp_backward_wrapper_refuses_on_cuda(dev):
    plan, params, x, cc = _setup(dev, 128, 256, 3, 4, torch.bfloat16, False)
    ops = fused_mlp.kernel_operands(plan, params["non_rigid_mlp"],
                                    params["cnl_mlp"], cc)
    nets = fused_mlp.pack_kernel_weights(plan, ops, backward=True)
    g = torch.zeros((1000, 4), device=dev)
    dx, grads = fused_mlp.launch_backward(plan, x, g, 4.3, None, nets)
    assert dx.shape == (1000, 3) and float(dx.abs().max()) == 0.0
    assert float(grads["cnl"]["w_h"][1].abs().max()) == 0.0
    with pytest.raises(ValueError, match="g must be"):
        fused_mlp.launch_backward(plan, x, g[:, :3].contiguous(), 4.3, None,
                                  nets)
    with pytest.raises(ValueError, match="g must be"):
        fused_mlp.launch_backward(plan, x, g.double(), 4.3, None, nets)
    with pytest.raises(ValueError, match="backward=True"):
        fused_mlp.launch_backward(
            plan, x, g, 4.3, None, fused_mlp.pack_kernel_weights(plan, ops))
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp.launch_backward(plan, x.cpu(), g.cpu(), 4.3, None, nets)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp.launch_forward(plan, x.cpu(), 4.3, None, nets)


def _resample_inputs(dev, K, D, G, cubic=False):
    """K bone volumes (D, D + 2, D + 4), or (D, D, D) when `cubic`, seeded
    affines and a cotangent that is zero at half of the grid points."""
    rng = np.random.RandomState(3)
    shape = (K, D, D, D) if cubic else (K, D, D + 2, D + 4)
    vols = rng.rand(*shape).astype(np.float32)
    vols[:, :, :2] = 0.0
    Rs = np.stack([np.eye(3) * rng.uniform(0.8, 1.2)
                   + 0.1 * rng.randn(3, 3) for _ in range(K)])
    Ts = rng.uniform(-0.2, 0.2, (K, 3))
    boxes = ([-1.0, -1.1, -0.9], [1.0, 0.9, 1.1], [-1.2, -1.2, -1.2],
             [1.2, 1.3, 1.1])
    cot = rng.randn(G ** 3, K).astype(np.float32)
    cot[rng.rand(G ** 3) < 0.5] = 0.0

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    return t(vols), t(Rs), t(Ts), [t(b) for b in boxes], t(cot)


def _resample_grads(fn, vols, Rs, Ts, boxes, G, dtype, cot):
    leaves = [t.clone().requires_grad_(True) for t in (vols, Rs, Ts)]
    fn(*leaves, *boxes, G, dtype).backward(cot)
    return [t.grad for t in leaves]


# (K, D, G, cubic volumes): odd volumes; the default model's shape (24 bones,
# 32^3, G = 48) and a G that is no multiple of the kernel's 512-thread
# stride (37); a volume too large for one block's shared memory, which the
# kernel cuts into z-chunks (64 x 66 x 68)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(3, 8, 10, False), (24, 16, 21, False),
                                   (5, 32, 12, False), (24, 32, 48, True),
                                   (24, 32, 37, True), (2, 64, 20, False)])
def test_resample_backward_kernel_matches_autograd(dev, dtype, shape):
    K, D, G, cubic = shape
    vols, Rs, Ts, boxes, cot = _resample_inputs(dev, K, D, G, cubic)
    before = fused_warp.resample_launches
    gk = _resample_grads(fused_warp.resample_all_bones, vols, Rs, Ts, boxes,
                         G, dtype, cot)
    torch.cuda.synchronize()
    assert fused_warp.resample_launches == before + 1
    gp = _resample_grads(fused_warp.resample_all_bones_plain, vols, Rs, Ts,
                         boxes, G, dtype, cot)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, a, b in zip(("d_vols", "dA", "dT"), gk, gp):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert rel_l2(a, b) <= tol, name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["all_zero", "one_pair"])
def test_resample_backward_kernel_cotangent_patterns(dev, dtype, case):
    """A cotangent of zeros gives exactly zero gradients (the kernel writes
    every entry itself: its outputs are not zeroed first); a single non-zero
    (point, bone) pair touches that bone alone."""
    K, D, G = 24, 32, 48
    vols, Rs, Ts, boxes, cot = _resample_inputs(dev, K, D, G, cubic=True)
    cot = torch.zeros_like(cot)
    if case == "one_pair":
        cot[(20 * G + 24) * G + 24, 7] = 1.5        # a point inside bone 7
    gk = _resample_grads(fused_warp.resample_all_bones, vols, Rs, Ts, boxes,
                         G, dtype, cot)
    gp = _resample_grads(fused_warp.resample_all_bones_plain, vols, Rs, Ts,
                         boxes, G, dtype, cot)
    if case == "all_zero":
        for a in gk:
            assert float(a.abs().max()) == 0.0
        return
    others = torch.ones(K, dtype=torch.bool, device=dev)
    others[7] = False
    assert float(gp[0][7].abs().max()) > 0           # the pair is live
    for a, b in zip(gk, gp):
        assert float(a[others].abs().max()) == 0.0
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        assert rel_l2(a[7], b[7]) <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1000, 8), (4097, 16), (30000, 48),
                                   (1, 8)])
def test_scatter_kernel_matches_autograd(dev, dtype, shape):
    N, G = shape
    rng = np.random.RandomState(4)
    U = torch.from_numpy(rng.randn(G, G, G, 16).astype(np.float32)).to(dev)
    U[..., 12] = U[..., 12].abs() + 0.2
    pts = torch.from_numpy(rng.uniform(-1.45, 1.45, (N, 3))
                           .astype(np.float32)).to(dev)
    if N == 1:
        pts[0] = 0.1                                 # one valid sample
    lo = torch.tensor([-1.2, -1.2, -1.2], device=dev)
    hi = torch.tensor([1.2, 1.25, 1.15], device=dev)
    live = torch.from_numpy(rng.rand(N) > 0.3).to(dev)
    if N == 1:
        live[0] = True
    cot = torch.from_numpy(rng.randn(N, 4).astype(np.float32)).to(dev)
    dU, dp, dU_p, dp_p = _scatter_both(U, pts, lo, hi, live, cot, dtype)
    assert dU.dtype == dtype and dU.shape == (G, G, G, 16)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    assert rel_l2(dU, dU_p) <= tol and rel_l2(dp, dp_p) <= tol
    assert float(dp[~live].abs().sum()) == 0.0


def _scatter_both(U, pts, lo, hi, live, cot, dtype):
    """(dU, d(pts)) through the kernel (one launch) and through autograd of
    the plain version."""
    def run(kernel):
        Ul = U.to(dtype).requires_grad_(True)
        pl_ = pts.clone().requires_grad_(True)
        if kernel:
            x, s = fused_warp.sample_packed_grad(Ul, pl_, lo, hi, live)
        else:
            x, s = fused_warp.sample_packed_volume(
                fused_warp.build_packed_volume(Ul), pl_, lo, hi, live)
        torch.cat([x, s], dim=1).backward(cot)
        return Ul.grad, pl_.grad
    before = fused_warp.scatter_launches
    dU, dp = run(True)
    torch.cuda.synchronize()
    assert fused_warp.scatter_launches == before + 1
    return (dU, dp) + run(False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["long_runs", "clipped_corner",
                                  "nan_on_invalid"])
def test_scatter_kernel_edge_cases(dev, dtype, case):
    """long_runs: rays of 128 samples over a fine grid's few cells, so most
    consecutive samples share a base voxel (the kernel merges their adds);
    clipped_corner: samples on the grid's last plane along each axis (the
    box and G make their coordinate exactly G - 1), whose base corner is
    clipped to G - 2; nan_on_invalid: the cotangent of every invalid sample
    is NaN, which the kernel never reads."""
    G, R, S = 16, 64, 128
    rng = np.random.RandomState(6)
    U = torch.from_numpy(rng.randn(G, G, G, 16).astype(np.float32)).to(dev)
    U[..., 12] = U[..., 12].abs() + 0.2
    lo = torch.full((3,), -1.5, device=dev)       # scale (G - 1) / 3 = 5
    hi = torch.full((3,), 1.5, device=dev)
    if case == "long_runs":
        o = rng.uniform(-1.0, 1.0, (R, 1, 3))
        d = rng.randn(R, 1, 3) * 0.15        # a ray crosses ~2 cells
        t = np.linspace(0.0, 1.0, S)[None, :, None]
        pts = (o + d * t).reshape(-1, 3)
    elif case == "clipped_corner":
        pts = rng.uniform(-1.4, 1.4, (R * S, 3))
        pts = np.where(rng.rand(R * S, 3) < 0.5, 1.5, pts)
    else:
        pts = rng.uniform(-1.8, 1.8, (R * S, 3))
    pts = torch.from_numpy(pts.astype(np.float32)).to(dev)
    live = torch.from_numpy(rng.rand(R * S) > 0.2).to(dev)
    cot = torch.from_numpy(rng.randn(R * S, 4).astype(np.float32)).to(dev)
    dtype_tol = 1e-4 if dtype == torch.float32 else 5e-2
    if case != "nan_on_invalid":
        dU, dp, dU_p, dp_p = _scatter_both(U, pts, lo, hi, live, cot, dtype)
        assert rel_l2(dU, dU_p) <= dtype_tol and rel_l2(dp, dp_p) <= dtype_tol
        if case == "long_runs":
            _, (flat, _, valid, _) = fused_warp.packed_acc(
                fused_warp.build_packed_volume(U), pts, lo, hi, live)
            f = flat[valid]
            assert float((f[1:] == f[:-1]).float().mean()) > 0.5
        else:
            assert float(dU[-1].float().abs().max()) > 0   # the last plane
        return
    # the kernel's own backward, handed NaN where a sample is invalid
    Ul = U.to(dtype).requires_grad_(True)
    acc = fused_warp._PackedSampleAcc.apply(Ul, pts, lo, hi, live)
    _, (_, _, valid, _) = fused_warp.packed_acc(
        fused_warp.build_packed_volume(U), pts, lo, hi, live)
    assert bool((~valid).any())
    d = torch.from_numpy(rng.randn(R * S, 16).astype(np.float32)).to(dev)
    d_nan = torch.where(valid[:, None], d, torch.full_like(d, float("nan")))
    dU, = torch.autograd.grad(acc, [Ul], d_nan)
    Up = U.to(dtype).requires_grad_(True)
    acc_p, _ = fused_warp.packed_acc(fused_warp.build_packed_volume(Up), pts,
                                     lo, hi, live)
    dU_p, = torch.autograd.grad(
        acc_p, [Up], torch.where(valid[:, None], d, torch.zeros_like(d)))
    assert bool(torch.isfinite(dU.float()).all())
    assert rel_l2(dU, dU_p) <= dtype_tol


def test_warp_backward_wrappers_refuse_on_cuda(dev):
    flat = torch.zeros(8, dtype=torch.int64, device=dev)
    w3 = torch.zeros((8, 3), device=dev)
    valid = torch.ones(8, dtype=torch.bool, device=dev)
    d = torch.zeros((8, 16), device=dev)
    assert fused_warp.scatter_grad_volume(flat, w3, valid, d, 4).shape \
        == (4, 4, 4, 16)
    with pytest.raises(TypeError):
        fused_warp.scatter_grad_volume(flat.int(), w3, valid, d, 4)
    with pytest.raises(TypeError):
        fused_warp.scatter_grad_volume(flat, w3, valid.to(torch.uint8), d, 4)
    with pytest.raises(ValueError, match="shape"):
        fused_warp.scatter_grad_volume(flat, w3, valid, d[:, :13], 4)
    with pytest.raises(ValueError, match="contiguous"):
        fused_warp.scatter_grad_volume(flat, w3.t().contiguous().t(), valid,
                                       d, 4)
    with pytest.raises(ValueError, match="expected"):
        fused_warp.scatter_grad_volume(flat.cpu(), w3, valid, d, 4)
    vols, Rs, Ts, boxes, cot = _resample_inputs(dev, 3, 8, 6)
    with pytest.raises(ValueError, match="g must be"):
        fused_warp.resample_backward(vols, Rs, Ts, *boxes, 6, torch.float32,
                                     cot[:-1])
    with pytest.raises(TypeError):
        fused_warp.resample_backward(vols.double(), Rs, Ts, *boxes, 6,
                                     torch.float32, cot)
    with pytest.raises(TypeError, match="no kernel"):
        fused_warp.resample_backward(vols, Rs, Ts, *boxes, 6, torch.float16,
                                     cot)


def _trilerp_inputs(dev, G, N, seed, spread=1.45):
    """A packed volume of a random (G, G, G, 16) field with S > 0, points
    over a box a little larger than the obs box (some out of range) and a
    band liveness of ~70 % live."""
    rng = np.random.RandomState(seed)
    U = torch.from_numpy(rng.randn(G, G, G, 16).astype(np.float32))
    U[..., 12] = U[..., 12].abs() + 0.2
    U8 = fused_warp.build_packed_volume(U).to(dev)
    pts = torch.from_numpy(rng.uniform(-spread, spread, (N, 3))
                           .astype(np.float32)).to(dev)
    lo = torch.tensor([-1.2, -1.2, -1.2], device=dev)
    hi = torch.tensor([1.2, 1.25, 1.15], device=dev)
    live = torch.from_numpy(rng.rand(N) > 0.3).to(dev)
    return U8, pts, lo, hi, live


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G", [24, 48])
@pytest.mark.parametrize("case", ["live_mask", "all_dead", "ragged",
                                  "out_of_range"])
def test_trilerp_kernel_matches_plain(dev, dtype, G, case):
    N = {"live_mask": 65536, "all_dead": 4096, "ragged": 100_003,
         "out_of_range": 30_000}[case]
    U8, pts, lo, hi, live = _trilerp_inputs(
        dev, G, N, seed=G, spread=3.0 if case == "out_of_range" else 1.45)
    U8 = U8.to(dtype)
    if case == "all_dead":
        live = torch.zeros_like(live)
    elif case != "live_mask":
        live = None
    before = trilerp.launches
    x, fg = trilerp.sample_packed_volume_t(U8, pts, lo, hi, live)
    torch.cuda.synchronize()
    assert trilerp.launches == before + 1
    xp, fgp = trilerp.sample_packed_volume_t_plain(U8, pts, lo, hi, live)
    assert x.shape == (N, 3) and fg.shape == (N,)
    assert bool(torch.isfinite(x).all() and torch.isfinite(fg).all())
    torch.testing.assert_close(x, xp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fg, fgp, rtol=1e-5, atol=1e-5)
    dead = fgp == 0
    assert float(x[dead].abs().sum()) == 0.0
    assert float(fg[dead].abs().sum()) == 0.0
    if case == "all_dead":
        assert bool(dead.all())
    else:
        assert 0 < int(dead.sum()) < N


def test_trilerp_wrapper_refuses_on_cuda(dev):
    U8, pts, lo, hi, live = _trilerp_inputs(dev, 8, 100, seed=0)
    trilerp.sample_packed_volume_t(U8, pts, lo, hi, live)
    with pytest.raises(TypeError):
        trilerp.sample_packed_volume_t(U8.half(), pts, lo, hi, live)
    with pytest.raises(TypeError):
        trilerp.sample_packed_volume_t(U8, pts, lo, hi, live.to(torch.uint8))
    with pytest.raises(ValueError, match="shape"):
        trilerp.sample_packed_volume_t(U8[..., :64].contiguous(), pts, lo,
                                       hi, live)
    with pytest.raises(ValueError, match="shape"):
        trilerp.sample_packed_volume_t(U8, pts, lo, hi, live[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        trilerp.sample_packed_volume_t(U8, pts.t().contiguous().t(), lo, hi,
                                       live)
    with pytest.raises(ValueError, match="expected"):
        trilerp.sample_packed_volume_t(U8.cpu(), pts, lo, hi, live)
    with pytest.raises(RuntimeError, match="forward only"):
        trilerp.sample_packed_volume_t(U8, pts.requires_grad_(True), lo, hi,
                                       live)
