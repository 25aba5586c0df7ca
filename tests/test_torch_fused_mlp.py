"""Port vs JAX package: the fused MLP query (kernel K1's plain version and
the Python around the kernel).

`query_points_plain` is held against the Pallas kernel run in interpret
mode (`query_points_fused_t`, with dead blocks, and `query_points_fused`
for ragged N) and against the jnp path. float32 agrees to 1e-4 on raw
values of magnitude ~1; bfloat16 to 0.05, as the JAX package's own kernel
test allows."""

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
DT = {"float32": (jnp.float32, torch.float32, 1e-4),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.05)}
ALPHA = 4.3


def _plans(dtype, skip_nr=False):
    jdt, tdt, _ = DT[dtype]
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
    p = np_like(tmpl, 11)
    # offsets of ~1e-2: visible, but small enough that the canonical
    # embedding's 2^9 top frequency does not turn bf16 rounding into noise
    p["non_rigid_mlp"]["output"]["w"] *= 0.05
    p["non_rigid_mlp"]["output"]["b"] *= 0.05
    rng = np.random.RandomState(12)
    x = (rng.randn(512, 3) * 0.5).astype(np.float32)
    cc = (rng.randn(69) * 0.1).astype(np.float32)
    return p, x, cc


def test_plan_matches_jax_plan():
    jp, tp = _plans("float32")
    assert tp.n_tensors() == jp.n_tensors()
    assert tp.cnl_skips == jp.cnl_skips and tp.nr_skips == jp.nr_skips
    assert tp.nr_embed_dim == jp.nr_embed_dim == 36
    assert tp.cnl_embed_dim == jp.cnl_embed_dim == 63
    jp2, tp2 = _plans("float32", skip_nr=True)
    assert tp2.n_tensors() == jp2.n_tensors() < tp.n_tensors()


def test_plan_from_cfg_defaults_and_flops():
    from humannerf_tpu.config import make_cfg as jmake
    from humannerf_tpu_torch.config import make_cfg as tmake
    jp = pallas_mlp.plan_from_cfg(jmake(opts=[]), jnp.bfloat16, False)
    tp = fused_mlp.plan_from_cfg(tmake(opts=[]), torch.bfloat16, False)
    assert tp.n_tensors() == jp.n_tensors() == 34
    assert (tp.nr_depth, tp.nr_width, tp.cnl_depth, tp.cnl_width) == \
        (jp.nr_depth, jp.nr_width, jp.cnl_depth, jp.cnl_width) == \
        (6, 128, 8, 256)
    # ~1.17 MFLOP a live sample at the default widths
    assert 1.1e6 < tp.flops_per_sample() < 1.25e6
    tp_skip = fused_mlp.plan_from_cfg(tmake(opts=[]), torch.bfloat16, True)
    assert tp_skip.flops_per_sample() < tp.flops_per_sample()


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("skip_nr", [False, True])
def test_plain_vs_pallas_interpret_with_dead_blocks(setup, dtype, skip_nr):
    p, x, cc = setup
    jp, tp = _plans(dtype, skip_nr)
    tol = DT[dtype][2]
    live = np.array([1, 0, 1, 1], np.int32)             # 4 tiles of 128
    ref = np.asarray(pallas_mlp.query_points_fused_t(
        jp, to_jax(p), jnp.asarray(x.T), jnp.asarray(ALPHA),
        jnp.asarray(cc), jnp.asarray(live), jnp.asarray(live), 128, 128)).T
    out = fused_mlp.query_points_plain(
        tp, to_torch(p), torch.from_numpy(x), ALPHA, torch.from_numpy(cc),
        torch.from_numpy(live)).numpy()
    assert out.shape == (512, 4)
    assert np.abs(out[128:256]).max() == 0 and np.abs(ref[128:256]).max() == 0
    assert np.abs(out[:128]).max() > 0.1
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DT))
def test_plain_vs_pallas_ragged_n(setup, dtype):
    p, x, cc = setup
    jp, tp = _plans(dtype)
    tol = DT[dtype][2]
    n = 300                                            # not a tile multiple
    ref = np.asarray(pallas_mlp.query_points_fused(
        jp, to_jax(p), jnp.asarray(x[:n]), jnp.asarray(ALPHA),
        jnp.asarray(cc), blk_fwd=128, blk_bwd=128))
    out = fused_mlp.query_points_fused(
        tp, to_torch(p), torch.from_numpy(x[:n]), ALPHA,
        torch.from_numpy(cc)).numpy()
    assert out.shape == (n, 4)
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


def test_plain_vs_jnp_path_and_offset_visible(setup):
    from humannerf_tpu.models import embedders as jemb
    from humannerf_tpu.models import mlps as jmlps
    p, x, cc = setup
    _, tp = _plans("float32")
    jp_ = to_jax(p)
    e = jemb.hannw_fourier_embed(jnp.asarray(x), 6, jnp.asarray(ALPHA))
    res = jmlps.apply_nonrigid_mlp(jp_["non_rigid_mlp"], e, jnp.asarray(x),
                                   jnp.asarray(cc), skips=NR["skips"],
                                   dtype=jnp.float32)
    ref = np.asarray(jmlps.apply_canonical_mlp(
        jp_["cnl_mlp"], jemb.fourier_embed(res["xyz"], 10), skips=(1,),
        dtype=jnp.float32))
    out = fused_mlp.query_points_plain(
        tp, to_torch(p), torch.from_numpy(x), ALPHA,
        torch.from_numpy(cc)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    _, tp_skip = _plans("float32", skip_nr=True)
    no_nr = fused_mlp.query_points_plain(
        tp_skip, to_torch(p), torch.from_numpy(x), ALPHA, None).numpy()
    assert np.abs(out - no_nr).max() > 1e-2


def test_condition_code_fold(setup):
    """relu([cc, e] @ W0 + b0) == relu(e @ W0[69:] + folded bias)."""
    p, x, cc = setup
    tp_ = to_torch(p)
    w0e, b0 = fused_mlp.fold_condition_code(tp_["non_rigid_mlp"], 36,
                                            torch.from_numpy(cc))
    e = torch.from_numpy(np.random.RandomState(1).randn(8, 36)
                         .astype(np.float32))
    full = torch.cat([torch.from_numpy(cc).expand(8, 69), e], dim=1) \
        @ tp_["non_rigid_mlp"]["block_mlps"][0]["w"] \
        + tp_["non_rigid_mlp"]["block_mlps"][0]["b"]
    np.testing.assert_allclose((e @ w0e + b0).numpy(), full.numpy(),
                               atol=1e-5)
    # and the JAX package folds to the same bias
    jp, _ = _plans("float32")
    kw = pallas_mlp.make_kernel_weights(
        jp, to_jax(p)["non_rigid_mlp"], to_jax(p)["cnl_mlp"],
        jnp.asarray(cc))
    np.testing.assert_allclose(b0.numpy(), np.asarray(kw[1]), atol=1e-5)


def _unchunk(chunks, rows):
    """The inverse of the bf16 weight layout, written out independently of
    the module: chunk c, row n, position 8 * ((k // 8) ^ (n % 8)) + k % 8
    holds w[64 c + k, n] (the 128-byte swizzle of 16-byte groups)."""
    a = chunks.float().numpy()
    C, N, W = a.shape
    assert W == 64
    k = np.arange(64)
    out = np.zeros((C * 64, N), np.float32)
    for n in range(N):
        out[:, n] = a[:, n, 8 * ((k // 8) ^ (n % 8)) + k % 8].reshape(-1)
    return out[:rows]


@pytest.mark.parametrize("dtype", list(DT))
def test_make_kernel_weights_layout(setup, dtype):
    p, _, cc = setup
    _, tp = _plans(dtype)
    nets = fused_mlp.make_kernel_weights(
        tp, to_torch(p)["non_rigid_mlp"], to_torch(p)["cnl_mlp"],
        torch.from_numpy(cc))
    nr, cnl = nets["nr"], nets["cnl"]
    assert (nr["epad"], cnl["epad"]) == (48, 64)
    # (in, out) in float32; bf16 stores hidden-layer matrices as k-chunks of
    # 64 input rows, (chunks, out, 64), swizzled
    chunked = dtype == "bfloat16"

    def shapes(ws):
        return [None if w is None else tuple(w.shape) for w in ws]
    if chunked:
        assert shapes(nr["w_e"]) == [(1, 16, 64), None, (1, 16, 64)]
        assert shapes(nr["w_h"]) == [None, (1, 16, 64), (1, 16, 64)]
        assert shapes(cnl["w_e"]) == [(1, 32, 64), None, (1, 32, 64), None]
        w0 = torch.from_numpy(_unchunk(cnl["w_e"][0], 64))
        wh = torch.from_numpy(_unchunk(nr["w_h"][2], 16))
    else:
        assert shapes(nr["w_e"]) == [(48, 16), None, (48, 16)]
        assert shapes(nr["w_h"]) == [None, (16, 16), (16, 16)]
        assert shapes(cnl["w_e"]) == [(64, 32), None, (64, 32), None]
        w0, wh = cnl["w_e"][0].float(), nr["w_h"][2].float()
    assert tuple(nr["w_out"].shape) == (16, 3)
    assert tuple(cnl["w_out"].shape) == (32, 4)
    assert float(w0[63:].abs().max()) == 0.0               # padded rows
    ref = to_torch(p)["cnl_mlp"]["pts_linears"][0]["w"].to(tp.compute_dtype)
    assert torch.equal(w0[:63], ref.float())
    ref_h = to_torch(p)["non_rigid_mlp"]["block_mlps"][2]["w"][:16]
    assert torch.equal(wh, ref_h.to(tp.compute_dtype).float())
    for net in (nr, cnl):
        ws = [w for w in net["w_h"] + net["w_e"] + [net["w_out"]]
              if w is not None]
        assert all(w.dtype == tp.compute_dtype and w.is_contiguous()
                   for w in ws)
        assert all(b.dtype == torch.float32 for b in net["b"])
    n_ops = sum(t is not None for net in (nr, cnl)
                for t in net["w_h"] + net["w_e"] + net["b"]
                + [net["w_out"], net["b_out"]])
    assert n_ops == tp.n_tensors()


@pytest.mark.parametrize("shape", [(16, 16), (48, 128), (63, 192),
                                   (100, 64), (256, 256)])
def test_swizzled_chunks_unpack_exactly(shape):
    K, N = shape
    w = torch.from_numpy(np.random.RandomState(K + N).randn(K, N)
                         .astype(np.float32))
    chunks = fused_mlp.swizzled_chunks(w)
    C = -(-K // 64)
    assert chunks.shape == (C, N, 64) and chunks.dtype == torch.bfloat16
    assert chunks.is_contiguous()
    full = _unchunk(chunks, C * 64)
    assert np.array_equal(full[:K], w.to(torch.bfloat16).float().numpy())
    assert not full[K:].any()                       # zero rows past K
    # every 16-byte group of a row moved as a whole, by XOR with row % 8
    a = chunks.float().numpy()
    assert np.array_equal(a[0, 9, 8:16], full[0:8, 9])    # 9 % 8 = 1: 0 <-> 1


@pytest.mark.parametrize("eps", [0.0, 0.3])
def test_ray_sort_order(eps):
    rng = np.random.RandomState(3)
    R, S = 96, 16
    fg = np.zeros((R, S), np.float32)
    for r in range(R):
        if r % 5 == 0:
            continue                                   # fully dead rays
        a = rng.randint(0, S - 2)
        fg[r, a:a + rng.randint(1, S - a)] = rng.uniform(0.1, 1.0)
    jo, ji = pallas_mlp.ray_sort_order(jnp.asarray(fg), eps)
    to_, ti = fused_mlp.ray_sort_order(torch.from_numpy(fg), eps)
    np.testing.assert_array_equal(to_.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(to_[ti].numpy(), np.arange(R))


def test_tile_liveness():
    fg = torch.zeros(300)
    fg[130] = 0.2
    fg[290] = 1.0
    assert fused_mlp.tile_liveness(fg).tolist() == [0, 1, 1]
    assert fused_mlp.tile_liveness(fg, 0.5).tolist() == [0, 0, 1]
    assert fused_mlp.tile_liveness(fg).dtype == torch.int32
    assert fused_mlp.TILE == 128


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing(setup):
    p, x, cc = setup
    _, tp = _plans("bfloat16")
    before = fused_mlp.launches
    args = (tp, to_torch(p), torch.from_numpy(x), ALPHA, torch.from_numpy(cc),
            torch.tensor([1, 1, 0, 1], dtype=torch.int32))
    a = fused_mlp.query_points_fused(*args)
    b = fused_mlp.query_points_plain(*args)
    assert torch.equal(a, b)
    assert fused_mlp.launches == before
