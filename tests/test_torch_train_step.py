"""The whole slice: the port's training step against the JAX package's.

Same parameters (numpy-seeded), same batch (the synthetic dataset, read once
and handed to both), `train.perturb 0`: `Trainer._loss_fn`'s value and every
parameter gradient, then two full steps (loss, backward, per-module Adam)
and the parameters after them. The JAX side runs with
`pallas.mlp_interpret true`, so its four kernels on the training path (fused
MLP forward and backward, resample backward, scatter) run in interpret mode;
its gradient function is jitted once per dtype for the whole file.

Tolerances. float32: loss 1e-5 relative; gradients 2e-3 relative L2 per
tensor (the two packages sum in different orders, and the canonical
embedding's top frequency, 2^9, amplifies the last bits of the non-rigid
offset); after two Adam steps the first moments (linear in the gradients,
the second of which is taken at parameters that already differ a little)
5e-2 relative L2, the parameters 2e-5 mean absolute and 1e-3 (= two updates
of lr) maximum per tensor: Adam divides by the gradient's magnitude, so
single entries whose gradient is near zero move by up to lr either way.
bfloat16: run with `canonical_mlp.multires 4`, because with the default 10
the top frequency turns bf16 rounding of the offset into noise in both
packages (gradients then differ by 30-90 % from each package's own float32
ones); loss 2e-2 relative, gradients relative L2 <= 0.12 per tensor against
the JAX package's (measured <= 4.5e-2): the two round at different places
and a relu unit near zero can be masked in one and not in the other. The
step's bf16 gradients are not held against float32 ones: for the non-rigid
net they differ by more than their norm in both packages; that comparison
is made per module, in test_torch_mlp_grad.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humannerf_tpu.config import make_cfg as jmake
from humannerf_tpu.ops import raymarch as jray
from humannerf_tpu_torch.config import make_cfg as tmake
from humannerf_tpu_torch.ops import raymarch as tray
from humannerf_tpu_torch.train.checkpoint import params_from_jax
from humannerf_tpu_torch.train.trainer import (Trainer, split_batch,
                                                to_device_batch)

from synthetic_data import write_synthetic_dataset
from torch_port_util import network_params, to_jax

torch.set_num_threads(1)
OPTS = [
    "N_samples", "8", "patch.size", "8", "patch.N_patches", "2",
    "warp.grid_size", "12",
    "mweight_volume.volume_size", "8", "mweight_volume.embedding_size", "16",
    "canonical_mlp.mlp_width", "32", "canonical_mlp.mlp_depth", "4",
    "non_rigid_motion_mlp.mlp_width", "16",
    "non_rigid_motion_mlp.mlp_depth", "3",
    "non_rigid_motion_mlp.skips", "[2]",
    "non_rigid_motion_mlp.kick_in_iter", "0",
    "non_rigid_motion_mlp.full_band_iter", "4",     # window half open
    "pose_decoder.mlp_width", "16", "pose_decoder.mlp_depth", "2",
    "pose_decoder.kick_in_iter", "0",
    "train.perturb", "0.0", "train.log_interval", "1000000",
    "progress.dump_interval", "1000000",
    "train.save_checkpt_interval", "1000000", "save_all", "False",
    "resume", "False", "pallas.mlp_interpret", "True",
]
ITER = 2


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    return write_synthetic_dataset(
        str(tmp_path_factory.mktemp("torch_train_synth")), n_frames=2,
        size=64)


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}" if prefix else k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}[{i}]"))
    else:
        out[prefix] = tree
    return out


def _no_checkpoints(mp):
    """A Trainer writes an 'init' checkpoint when it is built; even this
    small network's is 0.6 GB (the weight-volume decoder's first layers have
    fixed widths). These tests do not read it, so it is not written."""
    import humannerf_tpu.train.checkpoint as jck
    import humannerf_tpu_torch.train.checkpoint as tck
    mp.setattr(jck, "save_checkpoint", lambda *a, **k: None)
    mp.setattr(tck, "save_checkpoint", lambda *a, **k: None)


class Pair:
    """Both packages' trainers on the same parameters and batch."""

    def __init__(self, tmp, data_path, dtype, extra=()):
        from humannerf_tpu.data.datasets import Dataset
        from humannerf_tpu.parallel import mesh as mesh_lib
        from humannerf_tpu.train.trainer import Trainer as JTrainer
        opts = OPTS + ["dtype", dtype, "train.dataset", data_path] \
            + list(extra)
        self.opts = opts
        self.jcfg = jmake(opts=opts, base_dir=os.path.join(tmp, "j"))
        self.tcfg = tmake(opts=opts, base_dir=os.path.join(tmp, "t"))
        with pytest.MonkeyPatch.context() as mp:
            _no_checkpoints(mp)
            self.jt = JTrainer(self.jcfg, mesh=mesh_lib.make_mesh(1),
                               log=lambda *a: None)
            self.tt = Trainer(self.tcfg, log=lambda *a: None, device="cpu")
        tree = network_params(
            jax.tree.map(np.asarray, self.jt.params), seed=5)
        self.tree = tree
        self.jt.params = to_jax(tree)
        self.tt.set_params(params_from_jax(tree))
        ds = Dataset(self.jcfg, data_path, keyfilter=self.jcfg.train_keyfilter,
                     ray_shoot_mode="patch", bgcolor=[0, 0, 0], seed=0)
        self.items = [ds[0], ds[1]]
        self.jbatches = [
            {k: jnp.asarray(v) for k, v in it.items()
             if k not in ("frame_name", "num_valid_rays")}
            for it in self.items]
        self.tbatches = [to_device_batch(it, "cpu") for it in self.items]
        loss_fn = self.jt._loss_fn

        @jax.jit
        def jgrad(params, batch, iter_val):
            (loss, terms), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, batch, jax.random.key(0), iter_val)
            return loss, terms, grads
        self.jgrad = jgrad

    def torch_grads(self, i=0, it=ITER):
        self.tt.optimizer.zero_grad(set_to_none=True)
        loss, terms = self.tt._loss_fn(self.tt.params, self.tbatches[i],
                                       self.tt.gen, it)
        loss.backward()
        grads = {k: v.grad.numpy().copy()
                 for k, v in _flat(self.tt.params).items()}
        return float(loss.detach()), terms, grads


@pytest.fixture(scope="module")
def pair32(tmp_path_factory, data_path):
    return Pair(str(tmp_path_factory.mktemp("pair32")), data_path, "float32")


@pytest.fixture(scope="module")
def pair16(tmp_path_factory, data_path):
    return Pair(str(tmp_path_factory.mktemp("pair16")), data_path,
                "bfloat16", extra=["canonical_mlp.multires", "4"])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_batch_split_and_keys(pair32):
    frame, rays = split_batch(pair32.tbatches[0])
    assert set(rays) == {"rays_o", "rays_d", "near", "far"}
    assert "motion_weights_priors" in frame and "rays_o" not in frame
    b = pair32.tbatches[0]
    assert b["patch_ray_idx"].dtype == torch.int64
    assert b["target_patches"].shape == (2, 8, 8, 3)
    assert "frame_name" not in b and "num_valid_rays" not in b


def test_loss_and_every_gradient_float32(pair32):
    p = pair32
    jl, jterms, jg = p.jgrad(p.jt.params, p.jbatches[0],
                             jnp.asarray(float(ITER)))
    tl, tterms, tg = p.torch_grads()
    assert list(tterms) == list(jterms) == ["lpips", "mse"]
    assert tl == pytest.approx(float(jl), rel=1e-5)
    for k in tterms:
        assert float(tterms[k].detach()) == pytest.approx(float(jterms[k]), rel=1e-4)
    jflat = _flat(jax.tree.map(np.asarray, jg))
    assert set(jflat) == set(tg)
    errs = {k: _rel(tg[k], jflat[k]) for k in tg}
    worst = max(errs, key=errs.get)
    print("float32 gradient errors:", sorted(errs.items(),
                                             key=lambda kv: -kv[1])[:6])
    assert errs[worst] <= 2e-3, (worst, errs[worst])
    # every module gets a gradient, the pose refiner and the weight-volume
    # decoder through the resample and scatter backward
    for mod in ("cnl_mlp", "non_rigid_mlp", "pose_decoder",
                "mweight_vol_decoder"):
        assert max(np.abs(v).max() for k, v in tg.items()
                   if k.startswith(mod)) > 0, mod
    p.g32 = tg


def test_loss_and_every_gradient_bfloat16(pair16):
    p = pair16
    jl, _, jg = p.jgrad(p.jt.params, p.jbatches[0], jnp.asarray(float(ITER)))
    tl, _, tg = p.torch_grads()
    assert tl == pytest.approx(float(jl), rel=2e-2)
    jflat = _flat(jax.tree.map(np.asarray, jg))
    ej = {k: _rel(tg[k], jflat[k]) for k in tg}
    print("bfloat16 vs jax:", sorted(ej.items(), key=lambda kv: -kv[1])[:5])
    for k in tg:
        assert tg[k].dtype == np.float32 and tg[k].shape == jflat[k].shape
        assert ej[k] <= 0.12, (k, ej[k])


def test_two_full_steps_float32(pair32):
    p = pair32
    jparams, jstate = p.jt.params, p.jt.opt_state
    tlosses, jlosses = [], []
    p.tt.iter = 1
    for i in range(2):
        jl, _, jg = p.jgrad(jparams, p.jbatches[i], jnp.asarray(float(i + 1)))
        updates, jstate = p.jt.tx.update(jg, jstate, jparams)
        jparams = jax.tree.map(lambda a, u: a + u, jparams, updates)
        jlosses.append(float(jl))
        loss, _ = p.tt.train_step(p.tbatches[i])
        p.tt.iter += 1
        tlosses.append(float(loss))
    tparams = {k: v.detach().numpy().copy()
               for k, v in _flat(p.tt.params).items()}
    tmu = {k: p.tt.optimizer.state[v]["exp_avg"].numpy().copy()
           for k, v in _flat(p.tt.params).items()}
    steps_done = p.tt.scheduler.last_epoch
    # restore the pair for the tests that follow, whatever is asserted below
    p.tt.set_params(params_from_jax(p.tree))
    p.tt.iter = 1
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert steps_done == 2
    jflat = _flat(jax.tree.map(np.asarray, jparams))
    # first moments: every label's mu holds its own modules' leaves
    inner = jstate.inner_states
    labels = p.tt.labels
    start = _flat(p.tree)
    moved = 0.0
    for k, v in tparams.items():
        mod = k.split(".")[0]
        mu = _flat(jax.tree.map(np.asarray,
                                inner[labels[mod]].inner_state[0].mu[mod]),
                   mod)
        assert _rel(tmu[k], mu[k]) <= 5e-2, (k, _rel(tmu[k], mu[k]))
        d = np.abs(v - jflat[k])
        assert d.mean() <= 2e-5 and d.max() <= 1e-3, (k, d.mean(), d.max())
        moved = max(moved, np.abs(jflat[k] - start[k]).max())
    assert moved > 5e-4                       # two updates of ~lr each


def test_switches_choose_the_plain_routes(pair32, data_path, monkeypatch):
    """pallas.mlp / scatter / resample false: autograd through the plain
    versions; on the CPU that is what the default route computes too."""
    _no_checkpoints(monkeypatch)
    p = pair32
    _, _, base = p.torch_grads()
    cfg = tmake(opts=OPTS + ["dtype", "float32", "train.dataset", data_path,
                             "pallas.mlp", "False", "pallas.scatter", "False",
                             "pallas.resample", "False"],
                base_dir=p.tcfg.logdir + "_plain")
    tp = Trainer(cfg, log=lambda *a: None, device="cpu")
    tp.set_params(params_from_jax(p.tree))
    tp.optimizer.zero_grad(set_to_none=True)
    loss, _ = tp._loss_fn(tp.params, p.tbatches[0], tp.gen, ITER)
    loss.backward()
    for k, v in _flat(tp.params).items():
        assert _rel(v.grad.numpy(), base[k]) <= 1e-5, k


def test_stratified_sampling_with_injected_noise():
    rng = np.random.RandomState(0)
    near = rng.uniform(0.5, 1.0, 16).astype(np.float32)
    far = near + rng.uniform(0.5, 1.0, 16).astype(np.float32)
    noise = rng.rand(16, 8).astype(np.float32)
    jz = jray.sample_along_rays(jnp.asarray(near), jnp.asarray(far), 8)
    mids = 0.5 * (jz[..., 1:] + jz[..., :-1])
    upper = jnp.concatenate([mids, jz[..., -1:]], axis=-1)
    lower = jnp.concatenate([jz[..., :1], mids], axis=-1)
    ref = np.asarray(lower + (upper - lower) * jnp.asarray(noise))
    tz = tray.sample_along_rays(torch.from_numpy(near), torch.from_numpy(far),
                                8)
    out = tray.stratified_sampling(tz, noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    # the JAX function is the same formula on its own uniform numbers
    jout = np.asarray(jray.stratified_sampling(jz, jax.random.key(3)))
    assert (jout >= np.asarray(lower) - 1e-6).all() \
        and (jout <= np.asarray(upper) + 1e-6).all()
    gen = torch.Generator().manual_seed(3)
    a = tray.stratified_sampling(tz, gen)
    b = tray.stratified_sampling(tz, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, tz)
    assert (a.numpy() >= np.asarray(lower) - 1e-6).all() \
        and (a.numpy() <= np.asarray(upper) + 1e-6).all()
    with pytest.raises(ValueError, match="noise"):
        tray.stratified_sampling(tz, noise=torch.zeros(3, 3))


def test_perturbed_render_uses_the_injected_noise(pair32):
    p = pair32
    frame, rays = split_batch(p.tbatches[0])
    n = rays["rays_o"].shape[0]
    noise = torch.from_numpy(np.random.RandomState(1).rand(n, 8)
                             .astype(np.float32))
    params = {k: v for k, v in p.tt.params.items()}
    with torch.no_grad():
        a = p.tt.net.render_rays(params, frame, rays, 2.0, perturb=True,
                                 noise=noise, train=True)
        b = p.tt.net.render_rays(params, frame, rays, 2.0, perturb=True,
                                 noise=noise, train=True, chunk=n // 2)
        c = p.tt.net.render_rays(params, frame, rays, 2.0, perturb=False,
                                 train=True)
    np.testing.assert_allclose(a["rgb"].numpy(), b["rgb"].numpy(), atol=1e-5)
    assert float((a["rgb"] - c["rgb"]).abs().max()) > 1e-4


def test_gradients_agree_when_a_prior_underflows(pair32):
    """A prior of 1e-39 (a float32 denormal) in one voxel: XLA's CPU backend
    flushes it to 0, PyTorch keeps it, so the port's bone-support box is at
    least as wide and the voxel's samples are live in the port and may be
    dead in the JAX package. That is conservative for the backward too: the
    extra samples scatter cotangents onto a weight of ~1e-39, which the
    softmax's gradient multiplies by that weight. Loss and every parameter
    gradient agree as without the denormal."""
    from humannerf_tpu.ops import liveness as jlv
    from humannerf_tpu_torch.ops import liveness as tlv
    p = pair32
    prior = np.array(p.items[0]["motion_weights_priors"], np.float32)
    zero = np.argwhere(prior[:-1] == 0)
    assert len(zero) > 0
    # a zero-prior voxel outside the bone's current support box, if any
    k = int(zero[len(zero) // 2][0])
    cand = zero[zero[:, 0] == k]
    nz = np.argwhere(prior[k] > 0)
    far = cand[np.argmax(np.abs(cand[:, 1:] - nz.mean(axis=0)).sum(axis=1))]
    prior[tuple(far)] = 1e-39
    assert 0 < prior[tuple(far)] < np.finfo(np.float32).tiny
    jb = dict(p.jbatches[0], motion_weights_priors=jnp.asarray(prior))
    tb = dict(p.tbatches[0], motion_weights_priors=torch.from_numpy(prior))
    jl, _, jg = p.jgrad(p.jt.params, jb, jnp.asarray(float(ITER)))
    p.tt.optimizer.zero_grad(set_to_none=True)
    loss, _ = p.tt._loss_fn(p.tt.params, tb, p.tt.gen, ITER)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    jflat = _flat(jax.tree.map(np.asarray, jg))
    for key, v in _flat(p.tt.params).items():
        assert _rel(v.grad.numpy(), jflat[key]) <= 2e-3, key
    # the port's boxes contain the JAX package's
    from humannerf_tpu.models import mweight as jmw
    from humannerf_tpu_torch.models import mweight as tmw
    jw = jmw.decode_mweight_volume(p.jt.params["mweight_vol_decoder"],
                                   jnp.asarray(prior), dtype=jnp.float32)
    with torch.no_grad():
        tw = tmw.decode_mweight_volume(p.tt.params["mweight_vol_decoder"],
                                       torch.from_numpy(prior),
                                       dtype=torch.float32)
    assert float(jw[k][tuple(far[1:])]) == 0.0          # flushed
    jlo, jhi = jlv.bone_support_boxes(jw[:-1])
    tlo, thi = tlv.bone_support_boxes(tw[:-1])
    assert (tlo.numpy() <= np.asarray(jlo) + 1e-6).all()
    assert (thi.numpy() >= np.asarray(jhi) - 1e-6).all()
