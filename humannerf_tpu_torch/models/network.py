"""HumanNeRF network (mirrors humannerf_tpu/models/network.py).

  * `prepare_frame` runs the per-frame work once: pose refinement, motion
    basis, weight-volume decode, condition code, the fused observation-space
    volume and its packed form, the bone-support boxes of the live bands.
  * `render_block` renders one block of rays: depth samples, band liveness,
    packed-volume gather, the fused MLP query (ops/fused_mlp.py), and the
    compositor (ops/raymarch.raw2outputs, or ops/composite.py with
    `pallas.composite true`).
  * `render_rays` = prepare_frame + render_block over chunks.

All three run under autograd. With `train=True` the frame volume is
differentiated by the resample kernel (`pallas.resample`), the sample
gather by the scatter kernel (`pallas.scatter`) and the MLP query by the
fused backward kernel (`pallas.mlp`); each switch set to false takes
autograd through the plain version instead. Rendering without gradients is
the caller's business (`EvalRenderer` wraps its calls in `torch.no_grad`).

Only the default model family is ported; everything else raises
NotImplementedError naming its ROADMAP.md queue item.

Iteration-scheduled behaviour (hann-window alpha, kick-in gates) is decided
on the host from a Python float, so no gate costs a device synchronisation.
Padded rays (near = far = 0, zero directions) composite to pure background.
"""

from __future__ import annotations

import torch

from humannerf_tpu_torch import runtime
from humannerf_tpu_torch.models import mlps, mweight
from humannerf_tpu_torch.models.embedders import fourier_embed_dim, hann_alpha
from humannerf_tpu_torch.models.motion import motion_basis
from humannerf_tpu_torch.ops import composite as composite_op
from humannerf_tpu_torch.ops import fused_mlp
from humannerf_tpu_torch.ops import liveness as lv
from humannerf_tpu_torch.ops.fused_warp import (build_fused_volume,
                                                build_packed_volume,
                                                sample_packed_grad,
                                                sample_packed_volume)
from humannerf_tpu_torch.ops.raymarch import (raw2outputs, sample_along_rays,
                                              stratified_sampling)
from humannerf_tpu_torch.utils.transforms import posevec_representation

# ROADMAP.md queue A items that unsupported configurations are filed under
_TODO = {
    "analytic": "A2 (pallas.analytic_bands render route, kernel K5)",
    "warp": "A3 (warp.mode exact / unpacked fused volume, ops/trilinear)",
    "family": "A4 (non-default model family: multihead, view-dir, "
              "encoders, transformer offset nets, rgb-history, time inputs, "
              "local condition codes)",
    "outputs": "A5 (full_outputs: per-sample weights, canonical points, "
               "3D dumps)",
    "devices": "A6 (more than one device)",
}


def _unsupported(key: str, what: str):
    raise NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md item {_TODO[key]}")


class _PermuteRows(torch.autograd.Function):
    """x[perm] along dim 0 for a bijection `perm` with inverse `inv`: the
    backward is the gather g[inv], not the scatter-add autograd would use."""

    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(inv)
        return x[perm]

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        return g[inv], None, None


def check_supported(cfg):
    """Raise NotImplementedError for configurations outside this slice."""
    if cfg.dtype not in ("bfloat16", "float32"):
        raise ValueError(f"dtype must be bfloat16 or float32: {cfg.dtype}")
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if fused_mlp.plan_from_cfg(cfg, dtype, skip_nr=False) is None:
        _unsupported("family", "this model configuration")
    if cfg.warp.mode != "fused":
        _unsupported("warp", f"warp.mode {cfg.warp.mode!r}")
    if not cfg.warp.get("packed", True):
        _unsupported("warp", "warp.packed false")
    if cfg.warp.include_bone_weights:
        _unsupported("family", "warp.include_bone_weights")
    if cfg.get_path("pallas.analytic_bands", False):
        _unsupported("analytic", "pallas.analytic_bands true")


class HumanNeRF:
    """Static-config holder around the init/apply functions."""

    def __init__(self, cfg, device=None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = runtime.setup(device)
        self.total_bones = cfg.total_bones
        self.n_samples = cfg.N_samples
        self.cnl_pos_embed_dim = fourier_embed_dim(cfg.canonical_mlp.multires)
        self.nr_pos_embed_dim = 3 * 2 * cfg.non_rigid_motion_mlp.multires
        self.compute_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" \
            else torch.float32
        # (with non-rigid net, without it): the second is the plan of
        # cfg.ignore_non_rigid_motions, which starts at the canonical embed
        self.mlp_plans = (
            fused_mlp.plan_from_cfg(cfg, self.compute_dtype, skip_nr=False),
            fused_mlp.plan_from_cfg(cfg, self.compute_dtype, skip_nr=True))
        # tile-liveness statistics of the blocks rendered so far; the live
        # count stays on the device so that keeping it costs no sync
        self.tiles_total = 0
        self._tiles_live = None

    def dead_tile_share(self) -> float:
        """Share of kernel tiles skipped as dead since construction (one
        device read)."""
        if self.tiles_total == 0 or self._tiles_live is None:
            return 0.0
        return 1.0 - float(self._tiles_live) / self.tiles_total

    # -- init ---------------------------------------------------------------

    def init_params(self, seed) -> dict:
        """Seeded parameters in the JAX package's tree layout. `seed` is an
        int or a torch.Generator (CPU); the numbers are this package's own,
        not the JAX package's for the same seed."""
        cfg = self.cfg
        gen = seed if isinstance(seed, torch.Generator) \
            else torch.Generator().manual_seed(int(seed))
        c, nr, pd, mw = (cfg.canonical_mlp, cfg.non_rigid_motion_mlp,
                         cfg.pose_decoder, cfg.mweight_volume)
        dev = self.device
        params = {
            "mweight_vol_decoder": mweight.init_mweight_decoder(
                gen, embedding_size=mw.embedding_size,
                volume_size=mw.volume_size, total_bones=cfg.total_bones,
                device=dev),
            "non_rigid_mlp": mlps.init_nonrigid_mlp(
                gen, pos_embed_size=self.nr_pos_embed_dim,
                condition_code_size=nr.condition_code_size,
                mlp_width=nr.mlp_width, mlp_depth=nr.mlp_depth,
                skips=tuple(nr.skips), device=dev),
            "cnl_mlp": mlps.init_canonical_mlp(
                gen, input_ch=self.cnl_pos_embed_dim, mlp_depth=c.mlp_depth,
                mlp_width=c.mlp_width, device=dev),
        }
        if not cfg.pose_decoder_off:
            params["pose_decoder"] = mlps.init_pose_refiner(
                gen, embedding_size=pd.embedding_size, mlp_width=pd.mlp_width,
                mlp_depth=pd.mlp_depth, total_bones=cfg.total_bones,
                device=dev)
        return params

    # -- per-frame preparation ----------------------------------------------

    def prepare_frame(self, params: dict, frame: dict, iter_val: float,
                      train: bool = False) -> dict:
        """Pose refinement + motion basis + weight volume + condition code
        + packed warp volume + band boxes. Runs once per frame. train=True
        keeps the fused volume unpacked (`scatter_U`) when `pallas.scatter`
        routes the sample gather through the scatter kernel."""
        cfg = self.cfg
        iter_val = float(iter_val)
        dst_Rs, dst_Ts = frame["dst_Rs"], frame["dst_Ts"]
        dst_posevec = frame["dst_posevec"]

        if not cfg.pose_decoder_off:
            pose_out = mlps.apply_pose_refiner(
                params["pose_decoder"], dst_posevec,
                total_bones=cfg.total_bones, dtype=self.compute_dtype)
            if iter_val >= float(cfg.pose_decoder.kick_in_iter):
                refined = dst_Rs[1:] @ pose_out["Rs"]         # (23, 3, 3)
                dst_Rs = torch.cat([dst_Rs[:1], refined], dim=0)

        nr_cfg = cfg.non_rigid_motion_mlp
        cc = None
        if nr_cfg.pose_input and not cfg.ignore_non_rigid_motions:
            cc = frame.get("pose_condition")
            if cc is None:
                cc = posevec_representation(dst_posevec, cfg.posevec.type)
            if cc.dim() != 1:
                _unsupported("family", "a per-sample or sequence pose "
                                       "condition")
            if iter_val < float(nr_cfg.kick_in_iter):
                cc = torch.zeros_like(cc)

        scale_Rs, Ts = motion_basis(dst_Rs, dst_Ts, frame["cnl_gtfms"])
        mweights = mweight.decode_mweight_volume(
            params["mweight_vol_decoder"], frame["motion_weights_priors"],
            dtype=self.compute_dtype)

        margin = cfg.warp.bbox_margin
        obs_min = frame["dst_bbox_min_xyz"] - margin
        obs_max = frame["dst_bbox_max_xyz"] + margin
        U = build_fused_volume(
            mweights[:-1], scale_Rs, Ts, frame["cnl_bbox_min_xyz"],
            frame["cnl_bbox_scale_xyz"], obs_min, obs_max,
            cfg.warp.grid_size, dtype=self.compute_dtype,
            pallas_resample=bool(cfg.get_path("pallas.resample", True)))
        ctx = {
            "motion_scale_Rs": scale_Rs,
            "motion_Ts": Ts,
            "condition_code": cc,
            "hann_alpha": hann_alpha(iter_val, nr_cfg.multires,
                                     nr_cfg.kick_in_iter,
                                     nr_cfg.full_band_iter),
            "cnl_bbox_min_xyz": frame["cnl_bbox_min_xyz"],
            "cnl_bbox_scale_xyz": frame["cnl_bbox_scale_xyz"],
            "bgcolor": frame["bgcolor"],
            "obs_min": obs_min,
            "obs_max": obs_max,
        }
        # volume rows stored in the compute dtype: bf16 rows halve the
        # per-sample gather; the trilerp accumulates in float32
        if train and cfg.get_path("pallas.scatter", True):
            # packed inside sample_packed_grad, whose backward is the
            # scatter kernel
            ctx["scatter_U"] = U.to(self.compute_dtype)
        else:
            ctx["packed_volume"] = build_packed_volume(
                U.to(self.compute_dtype))
        if cfg.get_path("pallas.band_gather", True):
            # analytic per-ray live bands (ops/liveness.py): band-dead
            # samples skip their gather row and, in training, their scatter;
            # exact, every packed channel reads 0 there. Liveness is a gate,
            # not a function to differentiate.
            with torch.no_grad():
                ctx["band_sup_lo"], ctx["band_sup_hi"] = \
                    lv.bone_support_boxes(mweights[:-1])
            ctx["band_dims"] = tuple(mweights.shape[1:])
            ctx["band_obs_step"] = (obs_max - obs_min) \
                / (cfg.warp.grid_size - 1)
        return ctx

    # -- ray rendering --------------------------------------------------------

    def _query(self, plan, params, ctx, x_skel, fg, R, S, train=False):
        """Canonical-space samples (R*S, 3) ray-major -> raw (R*S, 4).

        With pallas.skip_empty the samples go to the kernel z-major (all
        rays at one depth slot are neighbours) and, with
        pallas.skip_sort_rays, with rays sorted by live-band centre: a
        ray's live samples are a contiguous z-band, so ray-major tiles
        almost never die wholesale while sorted z-major tiles outside the
        shared band do. Tile liveness is fg > skip_eps. The reorder is a
        bijection and a dead tile yields raw = 0 where fg = 0, so the
        composited result does not depend on it, and neither do the
        gradients: a dead tile's cotangent is exactly zero.
        """
        cfg = self.cfg
        sub = {k: params[k] for k in ("non_rigid_mlp", "cnl_mlp")
               if k in params}
        cc = None if cfg.ignore_non_rigid_motions else ctx["condition_code"]
        if not cfg.get_path("pallas.mlp", True):
            query = fused_mlp.query_points_plain
        elif x_skel.device.type == "cuda" and not train:
            # the kernel's operands (cast, padded, condition code folded)
            # are the same for every block of a frame: prepare them once.
            # In training they stay in the autograd graph and are rebuilt
            # by every call instead.
            if "mlp_kernel_weights" not in ctx:
                ctx["mlp_kernel_weights"] = fused_mlp.make_kernel_weights(
                    plan, sub.get("non_rigid_mlp"), sub["cnl_mlp"], cc)
            kw = ctx["mlp_kernel_weights"]

            def query(*args):
                return fused_mlp.query_points_fused(*args, kernel_weights=kw)
        else:
            query = fused_mlp.query_points_fused
        skip_eps = float(cfg.get_path("pallas.skip_eps", 0.0))
        N = R * S
        if not cfg.get_path("pallas.skip_empty", True):
            self.tiles_total += -(-N // fused_mlp.TILE)
            return query(plan, sub, x_skel.contiguous(), ctx["hann_alpha"],
                         cc, None)
        x3 = x_skel.reshape(R, S, 3)
        fg_rs = fg.detach().reshape(R, S)     # liveness only: no gradient
        order = inv = None
        if cfg.get_path("pallas.skip_zmajor", True):
            if cfg.get_path("pallas.skip_sort_rays", True):
                order, inv = fused_mlp.ray_sort_order(fg_rs, skip_eps)
                x3 = _PermuteRows.apply(x3, order, inv)
                fg_rs = fg_rs[order]
            xq = x3.transpose(0, 1).reshape(N, 3)          # z-major copy
            fgq = fg_rs.t().reshape(N)
        else:
            xq = x3.reshape(N, 3)
            fgq = fg_rs.reshape(N)
        live = fused_mlp.tile_liveness(fgq, skip_eps)
        self.tiles_total += live.numel()
        n_live = live.sum()
        self._tiles_live = n_live if self._tiles_live is None \
            else self._tiles_live + n_live
        raw = query(plan, sub, xq.contiguous(), ctx["hann_alpha"], cc, live)
        if cfg.get_path("pallas.skip_zmajor", True):
            raw = raw.reshape(S, R, 4).transpose(0, 1)     # (R, S, 4)
            if inv is not None:
                raw = _PermuteRows.apply(raw, inv, order)
        return raw.reshape(N, 4)

    def render_block(self, params: dict, ctx: dict, block: dict,
                     generator: torch.Generator | None = None, *,
                     perturb: bool = False, full_outputs: bool = False,
                     remat: bool = False, head_mode: str = "single",
                     train: bool = False, noise=None) -> dict:
        """Render one block of rays -> dict(rgb (R, 3), alpha (R,),
        depth (R,)). The per-sample outputs of the JAX package's
        raw2outputs route (weights, rgb on rays) are not returned: at
        serving sizes they are hundreds of MB a frame and nothing reads
        them without full_outputs.

        perturb jitters the depth samples within their bins with uniform
        noise from `generator`, or with `noise` (R, S) in [0, 1) when given.
        remat is accepted for the JAX signature and has no effect: the
        backward kernel recomputes the MLP's forward by itself.
        """
        if full_outputs:
            _unsupported("outputs", "full_outputs=True")
        if head_mode != "single":
            _unsupported("family", f"head_mode {head_mode!r}")
        cfg = self.cfg
        rays_o, rays_d = block["rays_o"], block["rays_d"]
        near, far = block["near"].reshape(-1), block["far"].reshape(-1)
        R = rays_o.shape[0]
        S = self.n_samples

        z_vals = sample_along_rays(near, far, S)              # (R, S)
        if perturb:
            z_vals = stratified_sampling(z_vals, generator, noise=noise)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        pts_flat = pts.reshape(-1, 3)

        live_band = None
        if "band_sup_lo" in ctx:
            with torch.no_grad():
                t0, t1 = lv.ray_band_intervals(
                    rays_o, rays_d, near, far, ctx["motion_scale_Rs"],
                    ctx["motion_Ts"], ctx["cnl_bbox_min_xyz"],
                    ctx["cnl_bbox_scale_xyz"], ctx["band_dims"],
                    ctx["band_sup_lo"], ctx["band_sup_hi"],
                    obs_step=ctx["band_obs_step"])
                live_band = lv.sample_live_mask(z_vals, t0, t1).reshape(-1)
        if "scatter_U" in ctx:
            x_skel, fg = sample_packed_grad(
                ctx["scatter_U"], pts_flat, ctx["obs_min"], ctx["obs_max"],
                live=live_band)
        else:
            x_skel, fg = sample_packed_volume(
                ctx["packed_volume"], pts_flat, ctx["obs_min"],
                ctx["obs_max"], live=live_band)

        plan = self.mlp_plans[1 if cfg.ignore_non_rigid_motions else 0]
        raw = self._query(plan, params, ctx, x_skel, fg, R, S, train=train)

        raw = raw.reshape(R, S, 4)
        fg = fg.reshape(R, S, 1)
        if cfg.get_path("pallas.composite", False):
            if train:
                raise ValueError(
                    "pallas.composite true has no gradient (the compositing "
                    "kernel is forward only): train with pallas.composite "
                    "false")
            return composite_op.composite(
                raw.contiguous(), fg.contiguous(), z_vals.contiguous(),
                rays_d.contiguous(), ctx["bgcolor"].contiguous())
        out = raw2outputs(raw, fg, z_vals, rays_d, ctx["bgcolor"])
        return {k: out[k] for k in ("rgb", "alpha", "depth")}

    def render_rays(self, params: dict, frame: dict, rays: dict, iter_val,
                    generator: torch.Generator | None = None, *,
                    perturb: bool = False, chunk: int | None = None,
                    full_outputs: bool = False, remat: bool = False,
                    head_mode: str = "single", train: bool = False,
                    noise=None) -> dict:
        """Full forward: prepare the frame once, render the rays in blocks
        of `chunk` (the last block may be shorter). The blocks draw their
        perturbation noise from `generator` one after the other."""
        ctx = self.prepare_frame(params, frame, iter_val, train=train)
        n_rays = rays["rays_o"].shape[0]
        kw = dict(perturb=perturb, full_outputs=full_outputs, remat=remat,
                  head_mode=head_mode, train=train)
        if chunk is None or chunk >= n_rays:
            return self.render_block(params, ctx, rays, generator=generator,
                                     noise=noise, **kw)
        outs = []
        for s in range(0, n_rays, chunk):
            blk = {k: v[s:s + chunk] for k, v in rays.items()}
            outs.append(self.render_block(
                params, ctx, blk, generator=generator,
                noise=None if noise is None else noise[s:s + chunk], **kw))
        return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}
