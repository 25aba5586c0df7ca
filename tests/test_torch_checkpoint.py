"""A checkpoint written by the JAX package is served by the port:
`save_checkpoint` (JAX) -> `load_checkpoint` + `params_from_jax` (port) ->
same render; and the render CLI on a tiny yaml writes PNGs and psnr/ssim."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humannerf_tpu.config import make_cfg as jmake
from humannerf_tpu.models.network import HumanNeRF as JNet
from humannerf_tpu.train import checkpoint as jckpt
from humannerf_tpu.train.optimizer import make_optimizer
from humannerf_tpu_torch.config import make_cfg as tmake
from humannerf_tpu_torch.models.network import HumanNeRF as TNet
from humannerf_tpu_torch.train import checkpoint as tckpt

from synthetic_data import write_synthetic_dataset
from torch_port_util import small_opts, synthetic_frame, to_jax, to_torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Checkpoints here are hundreds of MB each (Adam moments of the
    fixed-width decoder layers) and pytest keeps `tmp_path` of three runs."""
    yield
    for f in tmp_path.rglob("*.ckpt"):
        f.unlink()


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    """Including the optimizer state, whose pickled classes belong to
    packages the port never imports."""
    jcfg = jmake(opts=small_opts(dtype="float32"))
    jnet = JNet(jcfg)
    jparams = jnet.init_params(jax.random.key(0))
    _, opt_state = make_optimizer(jcfg, jparams)
    jckpt.save_checkpoint(str(tmp_path), "latest", 123, jparams, opt_state)

    payload = tckpt.load_checkpoint(str(tmp_path), "latest")
    assert payload["iter"] == 123
    tparams = tckpt.params_from_jax(payload["params"])
    jl = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    tl = dict(_leaves(tparams))
    assert set(jl) == set(tl)                      # every leaf consumed
    for k in jl:
        assert tl[k].dtype == torch.float32
        np.testing.assert_array_equal(tl[k].numpy(), jl[k], err_msg=k)
    tnet = TNet(tmake(opts=small_opts(dtype="float32")), device="cpu")
    tckpt.check_like(tparams, tnet.init_params(0))
    # and renders the same image (float32, atol 1e-4)
    frame, rays = synthetic_frame(16, n_rays=64)
    jout = jnet.render_rays(jparams, to_jax(frame), to_jax(rays),
                            jnp.asarray(1e7))
    tout = tnet.render_rays(tparams, to_torch(frame), to_torch(rays), 1e7)
    np.testing.assert_allclose(tout["rgb"].numpy(), np.asarray(jout["rgb"]),
                               atol=1e-4)


def test_port_checkpoint_roundtrip_and_jax_reads_it(tmp_path):
    tnet = TNet(tmake(opts=small_opts()), device="cpu")
    params = tnet.init_params(3)
    path = tckpt.save_checkpoint(str(tmp_path), "iter_5", 5, params)
    assert tckpt.ckpt_exists(str(tmp_path), "iter_5")
    assert path == tckpt.ckpt_path(str(tmp_path), "iter_5")
    back = tckpt.params_from_jax(
        tckpt.load_checkpoint(str(tmp_path), "iter_5")["params"])
    for (k, a), (_, b) in zip(_leaves(params), _leaves(back)):
        assert torch.equal(a, b), k
    jpayload = jckpt.load_checkpoint(str(tmp_path), "iter_5")
    assert jpayload["iter"] == 5
    assert set(jpayload["params"]) == set(params)


@pytest.mark.parametrize("bad", ["module", "entry", "layer_key", "missing"])
def test_params_from_jax_raises_on_what_it_does_not_know(bad):
    tnet = TNet(tmake(opts=small_opts()), device="cpu")
    tree = tckpt.params_to_numpy(tnet.init_params(0))
    if bad == "module":
        tree["dir_embed_fn"] = {"table": np.zeros((4, 27), np.float32)}
    elif bad == "entry":
        tree["cnl_mlp"]["output_density"] = tree["cnl_mlp"]["output"]
    elif bad == "layer_key":
        tree["cnl_mlp"]["output"]["scale"] = np.zeros(1, np.float32)
    else:
        del tree["non_rigid_mlp"]["output"]
    with pytest.raises(KeyError):
        tckpt.params_from_jax(tree)


def test_check_like_rejects_another_architecture():
    a = TNet(tmake(opts=small_opts()), device="cpu").init_params(0)
    b = TNet(tmake(opts=small_opts(**{"canonical_mlp.mlp_width": 64})),
             device="cpu").init_params(0)
    tckpt.check_like(a, a)
    with pytest.raises(ValueError):
        tckpt.check_like(a, b)


def test_render_cli_serves_a_jax_checkpoint(tmp_path):
    """python -m humannerf_tpu_torch.run --type movement --device cpu"""
    yaml = pytest.importorskip("yaml")
    ds = write_synthetic_dataset(str(tmp_path / "dataset"), n_frames=2,
                                 size=48)
    opts = dict(zip(small_opts()[0::2], small_opts()[1::2]))
    exp = {
        "movement": {"dataset": ds}, "N_samples": 16, "dtype": "float32",
        "warp": {"grid_size": 16},
        "mweight_volume": {"volume_size": 16, "embedding_size": 32},
        "canonical_mlp": {"mlp_width": 32, "mlp_depth": 6},
        "non_rigid_motion_mlp": {"mlp_width": 16, "mlp_depth": 5},
        "pose_decoder": {"mlp_width": 32, "mlp_depth": 2},
        "eval": {"metrics": ["psnr", "ssim"]}, "bgcolor": [0.0, 0.0, 0.0],
    }
    assert int(opts["N_samples"]) == exp["N_samples"]
    cfg_file = tmp_path / "tiny.yaml"
    cfg_file.write_text(yaml.safe_dump(exp))
    env = dict(os.environ, HUMANNERF_LOGDIR_BASE=str(tmp_path / "exp"),
               PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    jcfg = jmake(str(cfg_file), base_dir=str(tmp_path / "exp"))
    jparams = JNet(jcfg).init_params(jax.random.key(1))
    jckpt.save_checkpoint(jcfg.logdir, "latest", 10, jparams)

    res = subprocess.run(
        [sys.executable, "-m", "humannerf_tpu_torch.run", "--type",
         "movement", "--cfg", str(cfg_file), "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "loaded checkpoint latest (iter 10)" in res.stdout
    out_dir = os.path.join(jcfg.logdir, "latest")
    pngs = sorted(os.listdir(os.path.join(out_dir, "movement")))
    assert pngs == ["000000.png", "000001.png"]
    avg = open(os.path.join(out_dir, "movement-metrics.average.txt")).read()
    assert "p:" in avg and "s:" in avg            # psnr and ssim averages
    per = open(os.path.join(out_dir, "movement-metrics.perimg.txt")).read()
    assert per.count("frame_") == 2
    assert "metrics:" in res.stdout


# ---------------------------------------------------------------------------
# optimizer state and resume, both ways
# ---------------------------------------------------------------------------

def _tiny_tree(rng):
    """A parameter tree with the default family's modules and entries and
    tiny shapes: the optimizer state does not care what the leaves mean, and
    a real network's checkpoint is 0.6 GB with its moments."""
    def lin(i, o):
        return {"w": rng.randn(i, o).astype(np.float32),
                "b": rng.randn(o).astype(np.float32)}
    return {
        "mweight_vol_decoder": {
            "const_embedding": rng.randn(4).astype(np.float32),
            "block_mlp": lin(4, 8),
            "block_conv": [{"w": rng.randn(8, 4, 2, 2, 2).astype(np.float32),
                            "b": rng.randn(4).astype(np.float32)}]},
        "non_rigid_mlp": {"block_mlps": [lin(6, 5), lin(5, 5)],
                          "output": lin(5, 3)},
        "cnl_mlp": {"pts_linears": [lin(7, 6), lin(6, 6)],
                    "output": lin(6, 4)},
        "pose_decoder": {"block_mlps": [lin(9, 4)], "output": lin(4, 6)},
    }


def _rand_like(tree, rng):
    return jax.tree.map(
        lambda x: rng.randn(*x.shape).astype(np.float32) * 0.1, tree)


def _torch_leaf_tree(np_tree):
    from humannerf_tpu_torch.train.trainer import tree_map
    return tree_map(lambda t: t.clone().requires_grad_(True),
                    tckpt.params_from_jax(np_tree))


def _set_grads(tparams, np_grads):
    from humannerf_tpu_torch.train.optimizer import tree_leaves
    for t, g in zip(tree_leaves(tparams), tree_leaves(np_grads)):
        t.grad = torch.from_numpy(np.array(g, np.float32))


def _jax_steps(jcfg, jparams, grads, frozen=()):
    tx, state = make_optimizer(jcfg, jparams, frozen)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state,
                                   jparams)
        jparams = jax.tree.map(lambda a, u: a + u, jparams, updates)
    return tx, state, jparams


@pytest.mark.parametrize("frozen", [(), ("pose_decoder",)])
def test_jax_optimizer_state_resumes_in_the_port(tmp_path, frozen):
    """Adam moments and step counts of a JAX checkpoint carry over: the next
    update is the same in both packages (float32, 1e-6)."""
    from humannerf_tpu_torch.train.optimizer import make_optimizer as tmk
    from humannerf_tpu_torch.train.optimizer import tree_leaves
    opts = small_opts(dtype="float32") + ["train.lrate_decay", "1"]
    jcfg, tcfg = jmake(opts=opts), tmake(opts=opts)
    rng = np.random.RandomState(0)
    jparams = to_jax(_tiny_tree(rng))
    grads = [_rand_like(jparams, rng) for _ in range(3)]
    tx, state, jp2 = _jax_steps(jcfg, jparams, grads[:2], frozen)
    jckpt.save_checkpoint(str(tmp_path), "latest", 2, jp2, state)

    payload = tckpt.load_checkpoint(str(tmp_path), "latest")
    tparams = _torch_leaf_tree(payload["params"])
    opt, sched, labels = tmk(tcfg, tparams, frozen)
    n = tckpt.opt_state_from_jax(payload["opt_state"], opt, sched, tparams,
                                 labels)
    owned = [m for m in tparams if m not in frozen]
    assert n == sum(len(tree_leaves(tparams[m])) for m in owned) \
        == len(opt.state)
    assert sched.last_epoch == 2
    for group in opt.param_groups:
        base = tcfg.train.lr if group["label"] == "base" \
            else tcfg.train[f"lr_{group['label']}"]
        assert group["lr"] == pytest.approx(base * 0.1 ** (2 / 1000.0))
    # moments are the saved arrays
    inner = state.inner_states
    for mod in owned:
        adam = inner[labels[mod]].inner_state[0]
        for t, m, v in zip(tree_leaves(tparams[mod]),
                           jax.tree.leaves(adam.mu[mod]),
                           jax.tree.leaves(adam.nu[mod])):
            st = opt.state[t]
            assert float(st["step"]) == 2.0
            np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                          np.asarray(m))
            np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                          np.asarray(v))
    # the third update
    updates, _ = tx.update(jax.tree.map(jnp.asarray, grads[2]), state, jp2)
    jp3 = jax.tree.map(lambda a, u: a + u, jp2, updates)
    _set_grads(tparams, grads[2])
    opt.step()
    for (k, a), (_, b) in zip(_leaves(tparams),
                              _leaves(jax.tree.map(np.asarray, jp3))):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0, atol=1e-6,
                                   err_msg=k)


def test_port_optimizer_state_resumes_in_jax(tmp_path):
    """`opt_state_to_jax` flattens to the leaves of the JAX optimizer state,
    in its order: `restore_into` takes it, and the next update agrees."""
    from humannerf_tpu_torch.train.optimizer import (customized_lr_names,
                                                     tree_leaves)
    from humannerf_tpu_torch.train.optimizer import make_optimizer as tmk
    opts = small_opts(dtype="float32") + ["train.lrate_decay", "1"]
    jcfg, tcfg = jmake(opts=opts), tmake(opts=opts)
    rng = np.random.RandomState(1)
    np_params = _tiny_tree(rng)
    jparams = to_jax(np_params)
    grads = [_rand_like(jparams, rng) for _ in range(3)]
    tparams = _torch_leaf_tree(np_params)
    opt, sched, labels = tmk(tcfg, tparams)
    for g in grads[:2]:
        _set_grads(tparams, g)
        opt.step()
        sched.step()
    nest = tckpt.opt_state_to_jax(opt, sched, tparams, labels,
                                  ["base"] + customized_lr_names(tcfg))
    tckpt.save_checkpoint(str(tmp_path), "latest", 2, tparams, nest)

    tx, template = make_optimizer(jcfg, jparams)
    payload = jckpt.load_checkpoint(str(tmp_path), "latest")
    assert len(jax.tree.leaves(payload["opt_state"])) \
        == len(jax.tree.leaves(template))
    jp2, state = jckpt.restore_into(payload, jparams, template)
    assert type(state) is type(template)           # the template's own tree
    adam = state.inner_states["base"].inner_state[0]
    assert int(adam.count) == 2
    t0 = tree_leaves(tparams["cnl_mlp"])[0]
    np.testing.assert_array_equal(
        np.asarray(jax.tree.leaves(adam.mu["cnl_mlp"])[0]),
        opt.state[t0]["exp_avg"].numpy())
    updates, _ = tx.update(jax.tree.map(jnp.asarray, grads[2]), state,
                           jax.tree.map(jnp.asarray, jp2))
    jp3 = jax.tree.map(lambda a, u: jnp.asarray(a) + u, jp2, updates)
    _set_grads(tparams, grads[2])
    opt.step()
    for (k, a), (_, b) in zip(_leaves(tparams),
                              _leaves(jax.tree.map(np.asarray, jp3))):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0, atol=1e-6,
                                   err_msg=k)
    # the port reads its own nest back as well
    tparams2 = _torch_leaf_tree(np_params)
    opt2, sched2, _ = tmk(tcfg, tparams2)
    back = tckpt.load_checkpoint(str(tmp_path), "latest")
    assert tckpt.opt_state_from_jax(back["opt_state"], opt2, sched2,
                                    tparams2, labels) == len(opt.state)
    assert sched2.last_epoch == 2


def test_tolerant_restore_keeps_the_template(tmp_path):
    tnet = TNet(tmake(opts=small_opts()), device="cpu")
    template = tnet.init_params(0)
    saved = tckpt.params_to_numpy(tnet.init_params(1))
    del saved["pose_decoder"]                            # a missing module
    del saved["cnl_mlp"]["output"]["b"]                  # a missing leaf
    saved["non_rigid_mlp"]["block_mlps"] = \
        saved["non_rigid_mlp"]["block_mlps"][:-1]        # another depth
    saved["cnl_mlp"]["pts_linears"][0]["w"] = np.zeros((3, 3), np.float32)
    got = tckpt.restore_params({"params": saved}, template)
    t, g = dict(_leaves(template)), dict(_leaves(got))
    assert set(t) == set(g)
    for k in t:
        kept = (k.startswith(".pose_decoder") or k == ".cnl_mlp.output.b"
                or k.startswith(".non_rigid_mlp.block_mlps")
                or k == ".cnl_mlp.pts_linears[0].w")
        if kept:
            assert torch.equal(g[k], t[k]), k
        elif k.endswith(".w"):                 # biases start at 0 in both
            assert not torch.equal(g[k], t[k]), k
    # no optimizer state, or one of another shape, restores nothing
    from humannerf_tpu_torch.train.optimizer import make_optimizer as tmk
    tparams = _torch_leaf_tree(tckpt.params_to_numpy(template))
    opt, sched, labels = tmk(tmake(opts=small_opts()), tparams)
    assert tckpt.opt_state_from_jax(None, opt, sched, tparams, labels) == 0
    assert tckpt.opt_state_from_jax(({"base": ((),)},), opt, sched, tparams,
                                    labels) == 0
    assert len(opt.state) == 0 and sched.last_epoch == 0


TRAIN_OPTS = [
    "N_samples", "8", "patch.size", "8", "patch.N_patches", "2",
    "warp.grid_size", "12", "mweight_volume.volume_size", "8",
    "mweight_volume.embedding_size", "16",
    "canonical_mlp.mlp_width", "32", "canonical_mlp.mlp_depth", "4",
    "non_rigid_motion_mlp.mlp_width", "16",
    "non_rigid_motion_mlp.mlp_depth", "3", "non_rigid_motion_mlp.skips", "[]",
    "pose_decoder.mlp_width", "16", "pose_decoder.mlp_depth", "2",
    "train.lossweights.lpips", "0.0", "train.lossweights.mse", "1.0",
    "train.log_interval", "1000000", "progress.dump_interval", "1000000",
    "train.save_checkpt_interval", "2", "save_all", "False",
    "dtype", "float32", "train.perturb", "0.0",
]


def test_trainers_resume_each_others_checkpoints(tmp_path):
    """The port trains, checkpoints on its cadence and resumes at iter + 1;
    the JAX Trainer resumes from the port's file and the port from the JAX
    Trainer's, optimizer moments intact."""
    from humannerf_tpu.parallel import mesh as mesh_lib
    from humannerf_tpu.train.trainer import Trainer as JTrainer
    from humannerf_tpu_torch.data.loader import Loader, create_dataset
    from humannerf_tpu_torch.train.optimizer import tree_leaves
    from humannerf_tpu_torch.train.trainer import Trainer
    data = write_synthetic_dataset(str(tmp_path / "data"), n_frames=2,
                                   size=64)
    opts = TRAIN_OPTS + ["train.dataset", data]
    tcfg = tmake(opts=opts, base_dir=str(tmp_path))
    logs = []
    t1 = Trainer(tcfg, log=logs.append, device="cpu")
    assert tckpt.ckpt_exists(tcfg.logdir, "init") and t1.iter == 1
    loader = Loader(create_dataset(tcfg, "train", seed=0), shuffle=False,
                    prefetch=0)
    t1.train(loader=loader, max_steps=3)
    assert t1.iter == 4
    payload = tckpt.load_checkpoint(tcfg.logdir, "latest")
    assert payload["iter"] == 2                 # save_checkpt_interval 2
    # the port resumes its own file
    t2 = Trainer(tcfg, log=logs.append, device="cpu")
    assert t2.iter == t2.start_iter == 3
    assert any("resumed from latest at iter 3" in str(m) for m in logs)
    assert len(t2.optimizer.state) == len(tree_leaves(t2.params))
    assert t2.scheduler.last_epoch == 2
    # the JAX Trainer resumes the port's file
    jcfg = jmake(opts=opts, base_dir=str(tmp_path))
    assert jcfg.logdir == tcfg.logdir
    jt = JTrainer(jcfg, mesh=mesh_lib.make_mesh(1), log=lambda *a: None)
    assert jt.iter == 3
    adam = jt.opt_state.inner_states["base"].inner_state[0]
    assert int(adam.count) == 2
    p0 = tree_leaves(t2.params["cnl_mlp"])[0]
    np.testing.assert_array_equal(
        np.asarray(jax.tree.leaves(jt.params["cnl_mlp"])[0]),
        p0.detach().numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.tree.leaves(adam.mu["cnl_mlp"])[0]),
        t2.optimizer.state[p0]["exp_avg"].numpy())
    assert float(np.abs(np.asarray(
        jax.tree.leaves(adam.mu["cnl_mlp"])[0])).max()) > 0
    # and the port resumes the JAX Trainer's file
    jckpt.save_checkpoint(jcfg.logdir, "latest", 9, jt.params, jt.opt_state)
    t3 = Trainer(tcfg, log=lambda *a: None, device="cpu")
    assert t3.iter == 10 and t3.scheduler.last_epoch == 2
    p3 = tree_leaves(t3.params["cnl_mlp"])[0]
    assert torch.equal(t3.optimizer.state[p3]["exp_avg"],
                       t2.optimizer.state[p0]["exp_avg"])
    t3.train(loader=loader, max_steps=1)        # and goes on training
    assert t3.iter == 11
    for name in ("init", "latest"):             # 0.6 GB each: free them now
        os.remove(tckpt.ckpt_path(tcfg.logdir, name))


def test_train_cli_on_the_cpu(tmp_path):
    """`python -m humannerf_tpu_torch.train --cfg tiny.yaml --device cpu`
    trains and leaves a log and checkpoints that the next call would resume
    (the resume itself: test_trainers_resume_each_others_checkpoints)."""
    data = write_synthetic_dataset(str(tmp_path / "data"), n_frames=2,
                                   size=64)
    yaml = tmp_path / "tiny.yaml"
    lines = ["category: 'human_nerf'", "task: 'synthetic'", "subject: 's'",
             "experiment: 'tiny'", "train:", f"  dataset: '{data}'",
             "  maxiter: 2"]
    yaml.write_text("\n".join(lines) + "\n")
    env = dict(os.environ, PYTHONPATH=REPO,
               HUMANNERF_LOGDIR_BASE=str(tmp_path / "experiments"))
    cmd = [sys.executable, "-m", "humannerf_tpu_torch.train", "--cfg",
           str(yaml), "--device", "cpu"] + TRAIN_OPTS + [
               "train.log_interval", "1"]
    res = subprocess.run(cmd, cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "[iter 2] loss" in res.stdout
    found = [os.path.join(d, f) for d, _, fs in os.walk(str(tmp_path))
             for f in fs if f == "latest.ckpt"]
    assert len(found) == 1
    logdir = os.path.dirname(found[0])
    assert os.path.isfile(os.path.join(logdir, "logs.txt"))
    payload = tckpt.load_checkpoint(logdir, "latest")
    assert payload["iter"] == 3                 # finalize(): the next step
    assert payload["opt_state"] is not None
    for name in ("init", "latest"):             # 0.6 GB each: free them now
        os.remove(tckpt.ckpt_path(logdir, name))


@pytest.mark.parametrize("env", [{}, {"LOAD_C": "0"}, {"TUNE_D": "1"}])
def test_pretrained_modules_match_the_jax_package(tmp_path, monkeypatch, env):
    """Warm start from a checkpoint: which modules are adopted and which are
    frozen, with the LOAD_* / TUNE_* toggles, as in the JAX package."""
    from humannerf_tpu.train.modules import \
        apply_pretrained_modules as japply
    from humannerf_tpu_torch.train.modules import \
        apply_pretrained_modules as tapply
    for k in ("LOAD_C", "LOAD_D", "TUNE_C", "TUNE_D"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    pre = _tiny_tree(np.random.RandomState(7))
    fresh = _tiny_tree(np.random.RandomState(8))
    path = tckpt.save_checkpoint(str(tmp_path), "pre", 100,
                                 tckpt.params_from_jax(pre))
    opts = ["modules.pretrained_path", path,
            "modules.pose_decoder.tune", "True",
            "modules.mweight_vol_decoder.reinit", "True"]
    jp, jfrozen = japply(jmake(opts=opts), dict(fresh))
    tp, tfrozen = tapply(tmake(opts=opts),
                         dict(tckpt.params_from_jax(fresh)))
    assert tfrozen == jfrozen
    for (k, a), (_, b) in zip(_leaves(tp),
                              _leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=k)
    adopted = {"cnl_mlp": "LOAD_C" not in env, "non_rigid_mlp": True,
               "pose_decoder": True, "mweight_vol_decoder": False}
    for mod, took in adopted.items():
        src = pre if took else fresh
        a = dict(_leaves(tp[mod]))
        for k, v in _leaves(src[mod]):
            np.testing.assert_array_equal(a[k].numpy(), v)
    assert "pose_decoder" not in tfrozen            # tune
    assert ("non_rigid_mlp" in tfrozen) == ("TUNE_D" not in env)
    assert ("cnl_mlp" in tfrozen) == ("LOAD_C" not in env)
    # frozen modules are in no parameter group
    from humannerf_tpu_torch.train.optimizer import make_optimizer as tmk
    leaf = _torch_leaf_tree(tckpt.params_to_numpy(tp))
    opt, _, labels = tmk(tmake(opts=opts), leaf, tfrozen)
    assert {m for m, lab in labels.items() if lab == "frozen"} == set(tfrozen)
    in_groups = {id(p) for g in opt.param_groups for p in g["params"]}
    for mod in leaf:
        from humannerf_tpu_torch.train.optimizer import tree_leaves
        assert all((id(p) in in_groups) == (mod not in tfrozen)
                   for p in tree_leaves(leaf[mod]))
