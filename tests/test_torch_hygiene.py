"""Rules the port must keep: it imports neither jax nor the JAX package, it
runs on the card unless the CPU is asked for, unsupported configurations
raise NotImplementedError naming their ROADMAP.md item, and on CPU tensors
the kernel wrappers launch nothing."""

import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

from humannerf_tpu_torch import runtime
from humannerf_tpu_torch.config import make_cfg
from humannerf_tpu_torch.models.network import HumanNeRF

from torch_port_util import small_opts

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    p for p in glob.glob(os.path.join(REPO, "humannerf_tpu_torch", "**",
                                      "*.py"), recursive=True)
    if os.sep + "_build" + os.sep not in p      # build outputs, not sources
) + [os.path.join(REPO, "chip_smoke.py")]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "humannerf_tpu")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_port_has_the_expected_files():
    rel = {os.path.relpath(p, REPO) for p in PORT_FILES}
    for need in ("humannerf_tpu_torch/models/network.py",
                 "humannerf_tpu_torch/ops/fused_mlp.py",
                 "humannerf_tpu_torch/ops/composite.py",
                 "humannerf_tpu_torch/ops/_build.py",
                 "humannerf_tpu_torch/run.py",
                 "humannerf_tpu_torch/train/__main__.py",
                 "humannerf_tpu_torch/train/trainer.py",
                 "humannerf_tpu_torch/train/loss.py",
                 "humannerf_tpu_torch/train/optimizer.py",
                 "humannerf_tpu_torch/train/modules.py",
                 "humannerf_tpu_torch/models/lpips.py", "chip_smoke.py"):
        assert need in rel
    for src in ("fused_mlp.cu", "composite.cu", "fused_mlp_bwd.cu",
                "scatter.cu", "resample_bwd.cu", "fused_mlp_common.cuh"):
        assert os.path.isfile(os.path.join(REPO, "humannerf_tpu_torch",
                                           "csrc", src))


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[os.path.relpath(p, REPO) for p in PORT_FILES])
def test_no_file_imports_jax_or_the_jax_package(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_importing_every_module_loads_no_jax():
    mods = []
    for p in PORT_FILES[:-1]:
        rel = os.path.relpath(p, REPO)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith(".__init__")
                    else rel)
    code = (
        "import importlib, sys\n"
        "sys.modules['yaml'] = None\n"        # config must not need yaml
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from humannerf_tpu_torch.config import make_cfg\n"
        "make_cfg(opts=['N_samples', '8'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "for m in ('triton', 'PIL', 'cv2', 'imageio'):\n"
        "    assert m not in sys.modules, m\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("clean")


def test_device_helper_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    for asked in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            runtime.resolve_device(asked)
    with pytest.raises(RuntimeError):
        HumanNeRF(make_cfg(opts=small_opts()))
    assert runtime.resolve_device("cpu") == torch.device("cpu")
    assert runtime.setup("cpu") == torch.device("cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_more_than_one_device_raises():
    with pytest.raises(NotImplementedError, match="A6"):
        runtime.resolve_device(["cuda:0", "cuda:1"])
    with pytest.raises(NotImplementedError, match="A6"):
        HumanNeRF(make_cfg(opts=small_opts()), device=["cpu", "cpu"])


UNSUPPORTED_CFG = {
    "multihead": (["multihead.head_num", "2"], "A4"),
    "view_dir": (["canonical_mlp.view_dir", "True"], "A4"),
    "pose_color": (["canonical_mlp.pose_color", "direct"], "A4"),
    "input_encoder": (["canonical_mlp.input_encoder.enable", "True"], "A4"),
    "cnl_time_input": (["canonical_mlp.time_input", "True"], "A4"),
    "cnl_condition_code": (["canonical_mlp.condition_code_dim", "69"], "A4"),
    "nr_time_input": (["non_rigid_motion_mlp.time_input", "True"], "A4"),
    "transformer_offsets": (["non_rigid_motion_model",
                             "transformer_encoder"], "A4"),
    "mlp_sa_offsets": (["non_rigid_motion_model", "mlp_SA"], "A4"),
    "rgb_history": (["rgb_history.last_num", "2"], "A4"),
    "local_condition_code": (["condition_code.type", "local"], "A4"),
    "depth_plus": (["canonical_mlp.mlp_depth_plus", "1"], "A4"),
    "last_linear_scale": (["non_rigid_motion_mlp.last_linear_scale", "2"],
                          "A4"),
    "bone_weights": (["warp.include_bone_weights", "True"], "A4"),
    "warp_exact": (["warp.mode", "exact"], "A3"),
    "warp_unpacked": (["warp.packed", "False"], "A3"),
    "analytic_bands": (["pallas.analytic_bands", "True"], "A2"),
}


@pytest.mark.parametrize("name", list(UNSUPPORTED_CFG))
def test_unsupported_configuration_raises(name):
    opts, item = UNSUPPORTED_CFG[name]
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md item {item}"):
        HumanNeRF(make_cfg(opts=small_opts() + opts), device="cpu")


@pytest.mark.parametrize("kw,item", [
    (dict(full_outputs=True), "A5"), (dict(head_mode="all"), "A4"),
    (dict(head_mode="select"), "A4"),
    (dict(full_outputs=True, train=True), "A5"),
    (dict(head_mode="all", perturb=True), "A4")])
def test_unsupported_call_raises(kw, item):
    net = HumanNeRF(make_cfg(opts=small_opts()), device="cpu")
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md item {item}"):
        net.render_block({}, {}, {}, **kw)


UNSUPPORTED_TRAINING = {
    "frames_per_step": (["train.frames_per_step", "2"], {}, "A6"),
    "mesh": ([], {"mesh": object()}, "A6"),
    "multihead": (["multihead.head_num", "2"], {}, "A4"),
    "tar_pretrained": (["modules.pretrained_path", "/nowhere/ckpt.tar"], {},
                       "A4"),
}


@pytest.mark.parametrize("name", list(UNSUPPORTED_TRAINING))
def test_unsupported_training_configuration_raises(name, tmp_path):
    """None of them runs silently on another route."""
    from humannerf_tpu_torch.train.trainer import Trainer
    opts, kw, item = UNSUPPORTED_TRAINING[name]
    cfg = make_cfg(opts=small_opts() + opts, base_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md item {item}"):
        Trainer(cfg, log=lambda *a: None, device="cpu", **kw)


def test_training_with_the_forward_only_compositor_raises():
    from torch_port_util import synthetic_frame, to_torch
    cfg = make_cfg(opts=small_opts(**{"pallas.composite": True}))
    net = HumanNeRF(cfg, device="cpu")
    frame, rays = synthetic_frame(16, n_rays=8)
    with pytest.raises(ValueError, match="no gradient"):
        net.render_rays(net.init_params(0), to_torch(frame), to_torch(rays),
                        1.0, train=True)


def test_lpips_metric_and_multihead_eval_raise():
    from humannerf_tpu_torch.render import run
    with pytest.raises(NotImplementedError, match="A4"):
        run(make_cfg(opts=["eval.metrics", "['lpips', 'psnr']",
                           "multihead.head_num", "2"]), "movement",
            device="cpu")


def test_resolve_render_mode_matches_jax_package():
    from humannerf_tpu.config import make_cfg as jmake
    from humannerf_tpu.render import resolve_render_mode as jres
    from humannerf_tpu_torch.render import resolve_render_mode as tres
    for run_type in ("movement", "tpose", "tpose_pose_condition"):
        for env in ({}, {"FORCE_NON_RIGID_MOTIONS": "1"}):
            for named in ("", "custom"):
                o = ["render_folder_name", named] if named else []
                assert tres(make_cfg(opts=o), run_type, env) == \
                    jres(jmake(opts=o), run_type, env)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """Shape/dtype checks of the CUDA route are in Python the CPU reaches."""
    from humannerf_tpu_torch.ops import fused_mlp
    plan = fused_mlp.plan_from_cfg(make_cfg(opts=small_opts()),
                                   torch.bfloat16, False)
    with pytest.raises(ValueError, match="multiple of 64"):
        fused_mlp._check_plan_for_kernel(plan)       # widths 32 / 16
    full = fused_mlp.plan_from_cfg(make_cfg(opts=[]), torch.bfloat16, False)
    fused_mlp._check_plan_for_kernel(full)
    wide = fused_mlp.plan_from_cfg(
        make_cfg(opts=["canonical_mlp.multires", "11"]), torch.bfloat16,
        False)
    with pytest.raises(ValueError, match="embedding"):
        fused_mlp._check_plan_for_kernel(wide)


def test_build_module_is_inert_without_a_compiler(tmp_path, monkeypatch):
    """Importing ops/_build.py builds nothing; its sources are in the repo
    and the build directory is ignored by git."""
    from humannerf_tpu_torch.ops import _build
    names = [os.path.basename(s) for s in _build.sources()]
    assert names == ["composite.cu", "fused_mlp.cu", "fused_mlp_bwd.cu",
                     "resample_bwd.cu", "scatter.cu"]
    a = _build._digest(_build.sources())
    assert len(a) == 16 and a == _build._digest(_build.sources())
    # a shared header is part of the build's hash: an edit to one builds anew
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    (tmp_path / "k.cu").write_text('#include "k.cuh"\n')
    (tmp_path / "k.cuh").write_text("#define ROWS 64\n")
    before = _build._digest(_build.sources())
    (tmp_path / "k.cuh").write_text("#define ROWS 32\n")
    assert _build._digest(_build.sources()) != before
    monkeypatch.undo()
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    ignore = open(os.path.join(REPO, ".gitignore")).read().split()
    assert "humannerf_tpu_torch/_build/" in ignore
