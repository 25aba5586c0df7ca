"""What the port's render and training runs write beside their images and
checkpoints, against the JAX package:

* `RETURN_POSE=true`: `render.run` dumps each frame's pose-refiner output to
  `<out_dir>/<folder>-pose_refine_output.pkl`, with the JAX dump's keys and
  shapes, and the values of `humannerf_tpu.models.mlps.apply_pose_refiner`
  on the same weights and pose vectors (float32, atol 1e-5).
* `Trainer.train` appends one line to `<logdir>/metrics.jsonl` at every log
  interval, with exactly the keys the JAX package's `ExperimentLogger`
  writes for the same step: loss, it_per_sec, each loss term, step.
* a progress dataset that is not prepared does not stop training: the
  progress render's FileNotFoundError is caught, as in the JAX loop.

Tiny sizes on the CPU; no checkpoint is written (a Trainer's is 0.6 GB even
at these widths) and every file goes under pytest's tmp_path.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from humannerf_tpu.models import mlps as jmlps
from humannerf_tpu.utils.tracing import ExperimentLogger as JLogger
from humannerf_tpu_torch import render
from humannerf_tpu_torch.config import make_cfg as tmake
from humannerf_tpu_torch.models.network import HumanNeRF
from humannerf_tpu_torch.train import checkpoint as tck
from humannerf_tpu_torch.train.checkpoint import params_from_jax
from humannerf_tpu_torch.train.trainer import Trainer

from synthetic_data import write_synthetic_dataset
from torch_port_util import np_like, small_opts, to_jax

torch.set_num_threads(1)

TRAIN_OPTS = [
    "N_samples", "8", "patch.size", "8", "patch.N_patches", "2",
    "warp.grid_size", "12",
    "mweight_volume.volume_size", "8", "mweight_volume.embedding_size", "16",
    "canonical_mlp.mlp_width", "32", "canonical_mlp.mlp_depth", "4",
    "non_rigid_motion_mlp.mlp_width", "16",
    "non_rigid_motion_mlp.mlp_depth", "3",
    "pose_decoder.mlp_width", "16", "pose_decoder.mlp_depth", "2",
    "train.lossweights.lpips", "0.0", "train.lossweights.mse", "1.0",
    "train.lossweights.l1", "0.5",
    "train.log_interval", "1", "progress.dump_interval", "1000000",
    "train.save_checkpt_interval", "1000000", "save_all", "False",
    "resume", "False", "dtype", "float32",
]


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    return write_synthetic_dataset(
        str(tmp_path_factory.mktemp("run_outputs_synth")), n_frames=2,
        size=32)


def _train(tmp_path, data_path, monkeypatch, steps):
    """`steps` steps of a tiny float32 run whose progress split, the shipped
    yamls' `zju_387_test`, is not prepared: the registry names
    dataset/zju_mocap/387_test under the working directory, here an empty
    tmp_path."""
    monkeypatch.setattr(tck, "save_checkpoint", lambda *a, **k: None)
    monkeypatch.chdir(tmp_path)
    cfg = tmake(opts=TRAIN_OPTS + [
        "task", "zju_mocap", "subject", "387", "train.dataset", data_path,
        "progress.dataset", "zju_387_test"], base_dir=str(tmp_path))
    trainer = Trainer(cfg, log=lambda *a: None, device="cpu")
    start = trainer.iter
    trainer.train(max_steps=steps)
    return cfg, trainer, start


def test_metrics_jsonl_has_the_jax_payload(tmp_path, data_path,
                                           monkeypatch):
    cfg, trainer, start = _train(tmp_path, data_path, monkeypatch, 2)
    with open(os.path.join(cfg.logdir, "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln["step"] for ln in lines] == [start, start + 1]
    terms = [k for k, w in cfg.train.lossweights.items() if w > 0]
    assert sorted(terms) == ["l1", "mse"]
    for ln in lines:
        # the JAX package's logger on the same numbers writes the same line
        jdir = tmp_path / f"jax_{ln['step']}"
        jdir.mkdir()
        jlog = JLogger(str(jdir), enable_wandb=False)
        jlog.log({k: v for k, v in ln.items() if k != "step"},
                 step=ln["step"])
        jlog.finish()
        with open(jdir / "metrics.jsonl") as f:
            assert json.loads(f.read()) == ln
        assert list(ln) == ["loss", "it_per_sec", *terms, "step"]
        assert np.isfinite([ln[k] for k in ln]).all()
        assert ln["loss"] == pytest.approx(ln["mse"] + 0.5 * ln["l1"],
                                           rel=1e-6)


def test_training_runs_past_a_missing_progress_dataset(tmp_path, data_path,
                                                       monkeypatch):
    # progress() runs at the first step and raises FileNotFoundError there
    cfg, trainer, start = _train(tmp_path, data_path, monkeypatch, 1)
    assert not os.path.exists(tmp_path / "dataset")
    assert trainer.iter == start + 1
    assert not any(f.startswith("prog_") for f in os.listdir(cfg.logdir))


def test_return_pose_dumps_the_pose_refiner_output(tmp_path, data_path,
                                                   monkeypatch):
    cfg = tmake(opts=small_opts(**{"movement.dataset": data_path,
                                   "dtype": "float32", "chunk": "4096"}),
                base_dir=str(tmp_path))
    net = HumanNeRF(cfg, device="cpu")
    tree = np_like(net.init_params(0), seed=3)
    params = params_from_jax(tree)
    monkeypatch.setattr(render, "load_network",
                        lambda cfg, device=None: (net, params))
    monkeypatch.setenv("RETURN_POSE", "True")
    render.run(cfg, "movement", device="cpu")

    out_dir = os.path.join(cfg.logdir, cfg.load_net + cfg.eval_output_tag)
    with open(os.path.join(out_dir, "movement-pose_refine_output.pkl"),
              "rb") as f:
        dump = pickle.load(f)
    assert len(dump) == 2
    from humannerf_tpu_torch.data.loader import create_dataset
    dataset = create_dataset(cfg, "movement")
    jparams = to_jax(tree["pose_decoder"])
    for i in range(len(dataset)):
        item = dataset[i]
        got = dump[item["frame_name"].replace("/", "-")]
        want = jmlps.apply_pose_refiner(jparams, item["dst_posevec"],
                                        total_bones=cfg.total_bones)
        assert set(got) == set(want) == {"Rs", "rvec"}
        for k in want:
            assert isinstance(got[k], np.ndarray)
            assert got[k].shape == np.asarray(want[k]).shape
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       atol=1e-5)
    assert dump[item["frame_name"].replace("/", "-")]["Rs"].shape == \
        (cfg.total_bones - 1, 3, 3)
