"""Fused frame-volume warp (mirrors humannerf_tpu/ops/fused_warp.py, and for
training ops/pallas_resample.py and ops/pallas_scatter.py).

Trilinear interpolation is linear in the volume values, so the per-bone
constants (A_k, t_k) fuse into the volume channels:
    B(q) = sum_k w_k(q) A_k,  c(q) = sum_k w_k(q) t_k,  S(q) = sum_k w_k(q)
and x_skel(p) = (B(p) p + c(p)) / clamp(S(p)) needs ONE 16-channel lookup
per sample instead of 24 per-bone lookups.

Per frame: build U (G, G, G, 16) by resampling every bone's weight field
onto a regular observation-space grid, then pack each voxel's 8 trilinear
corners into one 128-channel row. Per sample: one row gather.

Training differentiates both steps, and each has a hand-written CUDA kernel
for its backward:

  * `resample_all_bones` (the resample of all bones onto the grid): backward
    by `csrc/resample_bwd.cu`, which replaces the Pallas TPU kernels
    `pallas_resample._bwd_kernel` / `_bwd_kernel_win`. Plain version:
    autograd through `resample_bone_weights`.
  * `sample_packed_grad` (pack + gather + trilerp of the samples): backward
    by `csrc/scatter.cu`, which replaces `pallas_scatter._slot_kernel`. Plain
    version: autograd through `sample_packed_volume`.

On a CPU tensor the backward of either is autograd through its plain
version; on a CUDA tensor it launches the kernel or raises. Both kernels
take the tensors the step holds as they are (g in its (G^3, K) layout; the
forward's int64 ids, bool mask and the unmasked cotangent) and are bound by
their adds on the card (see the sources).
"""

from __future__ import annotations

import torch

# launches of csrc/resample_bwd.cu and csrc/scatter.cu (CUDA tensors only)
resample_launches = 0
scatter_launches = 0


def _round(x, dtype):
    return x.to(dtype).to(torch.float32) if dtype != torch.float32 else x


def _axis_lerp(frac: torch.Tensor, size: int, dtype):
    """Fractional index (N,) -> the two nonzero entries of its 2-hot lerp
    row: clipped indices (i0, i1) and weights (a0, a1), zeros-padding
    semantics (an out-of-range corner weighs 0). Weights are formed in the
    compute dtype, as the JAX package forms its lerp matrix."""
    i0 = torch.floor(frac)
    w = _round(frac - i0, dtype)
    v0 = ((i0 >= 0) & (i0 <= size - 1)).to(torch.float32)
    v1 = ((i0 + 1 >= 0) & (i0 + 1 <= size - 1)).to(torch.float32)
    i0c = i0.clamp(0, size - 1).long()
    i1c = (i0 + 1).clamp(0, size - 1).long()
    return i0c, i1c, _round(1 - w, dtype) * v0, w * v1


def obs_axes(obs_min: torch.Tensor, obs_max: torch.Tensor,
             grid_size: int) -> torch.Tensor:
    """(3, G): the grid's coordinates along x, y and z."""
    t = torch.linspace(0.0, 1.0, grid_size, dtype=torch.float32,
                       device=obs_min.device)
    return obs_min[:, None] + (obs_max - obs_min)[:, None] * t[None, :]


def grid_from_axes(axes: torch.Tensor) -> torch.Tensor:
    """(3, G) axis coordinates -> the regular grid's (G^3, 3) xyz points,
    layout [z, y, x] to match the canonical volume layout."""
    xs, ys, zs = axes
    zg, yg, xg = torch.meshgrid(zs, ys, xs, indexing="ij")
    return torch.stack([xg, yg, zg], dim=-1).reshape(-1, 3)


def make_obs_grid(obs_min: torch.Tensor, obs_max: torch.Tensor,
                  grid_size: int) -> torch.Tensor:
    """Regular grid over the observation bbox, layout [z, y, x] to match the
    canonical volume layout. Returns (G^3, 3) xyz points."""
    return grid_from_axes(obs_axes(obs_min, obs_max, grid_size))


def resample_bone_weights(vol: torch.Tensor, pos: torch.Tensor,
                          cnl_bbox_min_xyz, cnl_bbox_scale_xyz,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """Trilinearly sample bone volumes (..., D, H, W) at positions
    (..., N, 3) -> (..., N); one bone, or all bones at once through equal
    leading dimensions.

    grid_sample(zeros, align_corners=True) semantics, written as the JAX
    package's three axis contractions V[z,y,x] -> phi_z -> phi_y -> phi_x:
    each lerp row has two nonzero entries, so each contraction is a
    two-term sum over gathered voxels (the dense 2-hot matrices would only
    add exact zeros). In bfloat16 mode the lerp weights and the volume are
    rounded to bf16 for the z contraction and the y/x contractions run in
    float32 on bf16-rounded weights, as in fused_warp.py:77-87 there.
    """
    D, H, W = vol.shape[-3:]
    coords = (pos - cnl_bbox_min_xyz) * cnl_bbox_scale_xyz - 1.0  # (x,y,z)
    fx = (coords[..., 0] + 1.0) * 0.5 * (W - 1)
    fy = (coords[..., 1] + 1.0) * 0.5 * (H - 1)
    fz = (coords[..., 2] + 1.0) * 0.5 * (D - 1)
    z0, z1, az0, az1 = _axis_lerp(fz, D, dtype)
    y0, y1, ay0, ay1 = _axis_lerp(fy, H, dtype)
    x0, x1, ax0, ax1 = _axis_lerp(fx, W, dtype)
    v = _round(vol.to(torch.float32), dtype).reshape(vol.shape[:-3] + (-1,))

    def at(zi, yi, xi):
        return torch.gather(v, -1, (zi * H + yi) * W + xi)

    def zsum(yi, xi):            # contract z at one (y, x) corner
        return az0 * at(z0, yi, xi) + az1 * at(z1, yi, xi)

    def ysum(xi):                # then y
        return ay0 * zsum(y0, xi) + ay1 * zsum(y1, xi)
    return ax0 * ysum(x0) + ax1 * ysum(x1)


def resample_all_bones_plain(motion_weights, motion_scale_Rs, motion_Ts,
                             cnl_bbox_min_xyz, cnl_bbox_scale_xyz, obs_min,
                             obs_max, grid_size: int,
                             dtype=torch.bfloat16, axes=None) -> torch.Tensor:
    """All bones (K, D, H, W) resampled at the G^3 grid points, each warped
    by its bone's affine -> (G^3, K). One batched call (the JAX package loops
    over the bones at trace time; eagerly that loop would cost 24x the
    launches). Differentiable by autograd: the plain version of
    `resample_all_bones`. axes: the grid's `obs_axes`, if already made."""
    if axes is None:
        axes = obs_axes(obs_min, obs_max, grid_size)
    grid = grid_from_axes(axes)                           # (G^3, 3)
    # per-bone warped positions of every grid point: grid @ A_k^T + t_k
    pos = torch.matmul(grid[None], motion_scale_Rs.transpose(1, 2)) \
        + motion_Ts[:, None, :]                           # (K, G^3, 3)
    return resample_bone_weights(motion_weights, pos, cnl_bbox_min_xyz,
                                 cnl_bbox_scale_xyz, dtype).t()


def resample_backward(vols, motion_scale_Rs, motion_Ts, cnl_bbox_min_xyz,
                      cnl_bbox_scale_xyz, obs_min, obs_max, grid_size: int,
                      dtype, g, axes=None):
    """Wrapper of the CUDA kernel `csrc/resample_bwd.cu`: g (G^3, K), the
    cotangent of `resample_all_bones`' output as autograd hands it -> (d(vols)
    (K, D, H, W), dA (K, 3, 3), dT (K, 3)), all float32. The kernel writes
    every entry of its outputs (no memset) and reads g in place. axes: the
    grid's `obs_axes`, if the caller kept them. CUDA tensors only."""
    global resample_launches
    dev = g.device
    if dev.type != "cuda":
        raise ValueError(f"resample_backward needs CUDA tensors, got {dev}")
    if vols.dim() != 4:
        raise ValueError(f"vols must be (K, D, H, W), got {tuple(vols.shape)}")
    K, D, H, W = vols.shape
    G = int(grid_size)
    if tuple(g.shape) != (G * G * G, K):
        raise ValueError(f"g must be ({G * G * G}, {K}), got {tuple(g.shape)}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"compute dtype {dtype} has no kernel")
    if axes is None:
        axes = obs_axes(obs_min, obs_max, G)
    for name, t, shape in (("vols", vols, (K, D, H, W)), ("g", g, g.shape),
                           ("motion_scale_Rs", motion_scale_Rs, (K, 3, 3)),
                           ("motion_Ts", motion_Ts, (K, 3)),
                           ("cnl_bbox_min_xyz", cnl_bbox_min_xyz, (3,)),
                           ("cnl_bbox_scale_xyz", cnl_bbox_scale_xyz, (3,)),
                           ("obs_min", obs_min, (3,)),
                           ("obs_max", obs_max, (3,)),
                           ("axes", axes, (3, G))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
    ins = [t.detach().contiguous() for t in (
        vols, motion_scale_Rs, motion_Ts, cnl_bbox_min_xyz,
        cnl_bbox_scale_xyz, axes, g)]
    # each bone's least and greatest cotangent: the kernel sizes its
    # fixed-point sums of d(vols) by them (one reduction launch)
    ins += torch.aminmax(ins[-1], dim=0)
    dvols = torch.empty_like(ins[0])
    daff = torch.empty((K, 12), dtype=torch.float32, device=dev)

    from humannerf_tpu_torch.ops._build import load_library
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.resample_backward(
            *[t.data_ptr() for t in ins], dvols.data_ptr(), daff.data_ptr(),
            K, D, H, W, G, 1 if dtype == torch.bfloat16 else 0,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"resample_backward failed to launch "
                           f"(cudaError {err})")
    resample_launches += 1
    return dvols, daff[:, :9].reshape(K, 3, 3), daff[:, 9:]


class _ResampleAllBones(torch.autograd.Function):
    """Forward: `resample_all_bones_plain`. Backward: the CUDA kernel on a
    CUDA tensor, autograd through the plain version on a CPU tensor. The
    bounding boxes are data, not parameters: they get no gradient."""

    @staticmethod
    def forward(ctx, vols, Rs, Ts, cnl_min, cnl_scale, obs_min, obs_max,
                grid_size, dtype):
        axes = obs_axes(obs_min, obs_max, grid_size)
        ctx.save_for_backward(vols, Rs, Ts, cnl_min, cnl_scale, obs_min,
                              obs_max, axes)
        ctx.grid_size, ctx.dtype = grid_size, dtype
        return resample_all_bones_plain(vols, Rs, Ts, cnl_min, cnl_scale,
                                        obs_min, obs_max, grid_size, dtype,
                                        axes=axes)

    @staticmethod
    def backward(ctx, g):
        (vols, Rs, Ts, cnl_min, cnl_scale, obs_min, obs_max,
         axes) = ctx.saved_tensors
        if g.device.type == "cpu":
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(True)
                          for t in (vols, Rs, Ts)]
                out = resample_all_bones_plain(
                    *leaves, cnl_min, cnl_scale, obs_min, obs_max,
                    ctx.grid_size, ctx.dtype, axes=axes)
                dvols, dA, dT = torch.autograd.grad(out, leaves, g)
        else:
            dvols, dA, dT = resample_backward(
                vols, Rs, Ts, cnl_min, cnl_scale, obs_min, obs_max,
                ctx.grid_size, ctx.dtype, g, axes=axes)
        return (dvols.to(vols.dtype), dA.to(Rs.dtype), dT.to(Ts.dtype),
                None, None, None, None, None, None)


def resample_all_bones(motion_weights, motion_scale_Rs, motion_Ts,
                       cnl_bbox_min_xyz, cnl_bbox_scale_xyz, obs_min, obs_max,
                       grid_size: int, dtype=torch.bfloat16) -> torch.Tensor:
    """`resample_all_bones_plain` with the hand-written backward kernel
    (counterpart of humannerf_tpu/ops/pallas_resample.resample_all_bones)."""
    return _ResampleAllBones.apply(
        motion_weights, motion_scale_Rs, motion_Ts, cnl_bbox_min_xyz,
        cnl_bbox_scale_xyz, obs_min, obs_max, int(grid_size), dtype)


def build_fused_volume(motion_weights: torch.Tensor,
                       motion_scale_Rs: torch.Tensor,
                       motion_Ts: torch.Tensor,
                       cnl_bbox_min_xyz, cnl_bbox_scale_xyz,
                       obs_min, obs_max, grid_size: int,
                       dtype=torch.bfloat16,
                       pallas_resample: bool = False) -> torch.Tensor:
    """Fuse all bones into one observation-space volume U (G, G, G, 16):
      [0:9]  sum_k w_k A_k (row-major 3x3)
      [9:12] sum_k w_k t_k
      [12]   sum_k w_k            (fg likelihood)
      [13:16] zero padding
    pallas_resample (the config's `pallas.resample`, named as in the JAX
    package): differentiate the resample with the hand-written kernel
    (`resample_all_bones`) instead of autograd through the plain version;
    the forward is the same either way.
    """
    K = motion_weights.shape[0]
    rs = resample_all_bones if pallas_resample else resample_all_bones_plain
    w = rs(motion_weights, motion_scale_Rs, motion_Ts, cnl_bbox_min_xyz,
           cnl_bbox_scale_xyz, obs_min, obs_max, grid_size, dtype)  # (G^3, K)
    A_flat = motion_scale_Rs.reshape(K, 9)
    U = torch.cat([w @ A_flat, w @ motion_Ts,
                   torch.sum(w, dim=-1, keepdim=True),
                   torch.zeros((w.shape[0], 3), dtype=w.dtype,
                               device=w.device)], dim=-1)
    G = grid_size
    return U.reshape(G, G, G, -1)


def build_packed_volume(U: torch.Tensor) -> torch.Tensor:
    """U (G, G, G, C) -> (G, G, G, 8*C): channels [k*C:(k+1)*C] hold the
    (dz, dy, dx) = bits-of-k corner neighbour (edge-replicated), so one
    sample lookup is exactly one row gather."""
    parts = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                s = U
                if dz:
                    s = torch.cat([s[1:], s[-1:]], 0)
                if dy:
                    s = torch.cat([s[:, 1:], s[:, -1:]], 1)
                if dx:
                    s = torch.cat([s[:, :, 1:], s[:, :, -1:]], 2)
                parts.append(s)
    return torch.cat(parts, dim=-1)


def _fractional(pts, obs_min, obs_max, G: int):
    """Shared coordinate math of the packed-volume read: base-corner voxel
    id (N,), fractions (N, 3) as (x, y, z), in-range mask (N,), scale (3,)."""
    scale = (G - 1) / (obs_max - obs_min)
    f = (pts - obs_min) * scale
    i0 = torch.floor(f).clamp(0, G - 2)
    w3 = f - i0
    valid = ((f >= 0) & (f <= G - 1)).all(dim=1)
    i0 = i0.long()
    flat = (i0[:, 2] * G + i0[:, 1]) * G + i0[:, 0]
    return flat, w3, valid, scale


def _corner_weights(w3):
    wx, wy, wz = w3[:, 0], w3[:, 1], w3[:, 2]
    return torch.stack([
        (1 - wz) * (1 - wy) * (1 - wx), (1 - wz) * (1 - wy) * wx,
        (1 - wz) * wy * (1 - wx),       (1 - wz) * wy * wx,
        wz * (1 - wy) * (1 - wx),       wz * (1 - wy) * wx,
        wz * wy * (1 - wx),             wz * wy * wx], dim=1)


def packed_acc(U8: torch.Tensor, pts: torch.Tensor, obs_min, obs_max,
               live: torch.Tensor | None = None):
    """Trilinear read of the packed volume -> acc (N, C) float32, zero for
    out-of-range and (with `live`) dead samples; plus what the backward
    needs: (flat (N,) long, w3 (N, 3), valid (N,) bool, scale (3,))."""
    G = U8.shape[0]
    C8 = U8.shape[-1]
    C = C8 // 8
    rows = U8.reshape(G * G * G, C8)
    flat, w3, valid, scale = _fractional(pts, obs_min, obs_max, G)
    if live is not None:
        lv = live.reshape(-1) > 0
        valid = valid & lv
        flat = torch.where(lv, flat, torch.zeros_like(flat))
    g = rows[flat].reshape(-1, 8, C)                       # one gather
    w8 = _corner_weights(w3)
    # weighted corner sum as elementwise multiply-and-sum: as an einsum it
    # would become a million tiny matrix-vector products
    acc = (g.to(torch.float32) * w8[:, :, None]).sum(dim=1)
    acc = torch.where(valid[:, None], acc, torch.zeros_like(acc))
    return acc, (flat, w3, valid, scale)


def skel_from_acc(acc: torch.Tensor, pts: torch.Tensor):
    """acc (N, >= 13) -> (x_skel (N, 3), fg (N, 1))."""
    B = acc[:, :9].reshape(-1, 3, 3)
    c = acc[:, 9:12]
    S = acc[:, 12:13]
    x_skel = ((B * pts[:, None, :]).sum(dim=-1) + c) / S.clamp(min=1e-4)
    return x_skel, S


def sample_packed_volume(U8: torch.Tensor, pts: torch.Tensor, obs_min,
                         obs_max, live: torch.Tensor | None = None):
    """Single-gather trilerp of a packed volume -> (x_skel (N,3), fg (N,1)).

    Out-of-range points get fg = 0 wholesale. live: optional (N,) bool
    conservative liveness (ops/liveness.py bands) -- dead samples read the
    shared row 0 and output exactly 0, which equals the unmasked result by
    the band guarantee. Differentiable by autograd: with
    `build_packed_volume` the plain version of `sample_packed_grad`.
    """
    acc, _ = packed_acc(U8, pts, obs_min, obs_max, live)
    return skel_from_acc(acc, pts)


def scatter_grad_volume(flat, w3, valid, d_acc, grid_size: int):
    """Wrapper of the CUDA kernel `csrc/scatter.cu`: the transpose of the
    packed-volume read, on the tensors the forward kept: flat (N,) int64
    base-corner voxel ids, w3 (N, 3) float32 fractions, valid (N,) bool,
    d_acc (N, 16) float32 unmasked (an invalid sample's row is never read)
    -> dU (G, G, G, 16) float32. CUDA tensors only."""
    global scatter_launches
    dev = d_acc.device
    if dev.type != "cuda":
        raise ValueError(f"scatter_grad_volume needs CUDA tensors, got {dev}")
    n = d_acc.shape[0]
    G = int(grid_size)
    for name, t, shape, dt in (("flat", flat, (n,), torch.int64),
                               ("w3", w3, (n, 3), torch.float32),
                               ("valid", valid, (n,), torch.bool),
                               ("d_acc", d_acc, (n, 16), torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dU = torch.zeros((G, G, G, 16), dtype=torch.float32, device=dev)
    if n == 0:
        return dU
    from humannerf_tpu_torch.ops._build import load_library
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.scatter_volume_backward(
            flat.data_ptr(), w3.data_ptr(), valid.data_ptr(),
            d_acc.data_ptr(), dU.data_ptr(), n, G,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scatter_volume_backward failed to launch "
                           f"(cudaError {err})")
    scatter_launches += 1
    return dU


def d_pts_closed_form(g8, w3, d_acc, valid, scale):
    """d(pts) of the packed-volume read, through the corner weights only
    (floor and clip have zero gradient): g8 (N, 8, C) the gathered corner
    rows, d_acc (N, C) the cotangent, valid (N,) bool; an invalid sample's
    d(pts) is 0 whatever its cotangent holds."""
    d_w8 = (g8.to(torch.float32) * d_acc[:, None, :]).sum(dim=-1)   # (N, 8)
    fx = torch.stack([1.0 - w3[:, 0], w3[:, 0]], dim=1)
    fy = torch.stack([1.0 - w3[:, 1], w3[:, 1]], dim=1)
    fz = torch.stack([1.0 - w3[:, 2], w3[:, 2]], dim=1)
    sign = w3.new_tensor([-1.0, 1.0])
    k = torch.arange(8, device=w3.device)
    iz, iy, ix = k >> 2, (k >> 1) & 1, k & 1
    # d w8_k / d w_axis = +-(product of the other two axes' factors)
    d_wx = (d_w8 * fz[:, iz] * fy[:, iy] * sign[ix]).sum(dim=1)
    d_wy = (d_w8 * fz[:, iz] * fx[:, ix] * sign[iy]).sum(dim=1)
    d_wz = (d_w8 * fy[:, iy] * fx[:, ix] * sign[iz]).sum(dim=1)
    d_pts = torch.stack([d_wx, d_wy, d_wz], dim=1) * scale[None, :]
    return torch.where(valid[:, None], d_pts, torch.zeros_like(d_pts))


class _PackedSampleAcc(torch.autograd.Function):
    """acc = trilinear read of the packed form of U. Forward: pack + gather
    + trilerp (`build_packed_volume`, `packed_acc`). Backward: dU by the
    CUDA kernel on a CUDA tensor and d(pts) in closed form; on a CPU tensor
    both by autograd through the plain version. dU comes back in U's dtype;
    boxes and liveness get no gradient."""

    @staticmethod
    def forward(ctx, U, pts, obs_min, obs_max, live):
        acc, (flat, w3, valid, scale) = packed_acc(
            build_packed_volume(U), pts, obs_min, obs_max, live)
        ctx.save_for_backward(U, pts, obs_min, obs_max, live, flat, w3,
                              valid, scale)
        return acc

    @staticmethod
    def backward(ctx, d_acc):
        (U, pts, obs_min, obs_max, live, flat, w3, valid,
         scale) = ctx.saved_tensors
        need_pts = ctx.needs_input_grad[1]
        if d_acc.device.type == "cpu":
            with torch.enable_grad():
                leaves = [U.detach().requires_grad_(True)]
                p = pts.detach()
                if need_pts:
                    p = p.requires_grad_(True)
                    leaves.append(p)
                acc, _ = packed_acc(build_packed_volume(leaves[0]), p,
                                    obs_min, obs_max, live)
                grads = torch.autograd.grad(acc, leaves, d_acc)
            return (grads[0], grads[1] if need_pts else None, None, None,
                    None)
        # the step's own tensors: the kernel reads a sample's validity
        # before its cotangent, so an invalid sample's never reaches dU
        d_acc = d_acc.contiguous()
        G = U.shape[0]
        dU = scatter_grad_volume(flat, w3, valid, d_acc, G).to(U.dtype)
        d_pts = None
        if need_pts:
            C = U.shape[-1]
            g8 = build_packed_volume(U).reshape(G * G * G, 8 * C)[flat] \
                .reshape(-1, 8, C)
            d_pts = d_pts_closed_form(g8, w3, d_acc, valid, scale) \
                .to(pts.dtype)
        return dU, d_pts, None, None, None


def sample_packed_grad(U: torch.Tensor, pts: torch.Tensor, obs_min, obs_max,
                       live: torch.Tensor | None = None):
    """Pack + sample for the training path -> (x_skel (N, 3), fg (N, 1)),
    with the hand-written scatter kernel as the backward of the gather
    (counterpart of humannerf_tpu/ops/pallas_scatter.sample_packed_grad).
    U (G, G, G, 16) in the compute dtype; live: optional (N,) liveness."""
    if U.shape[-1] != 16:
        raise ValueError(f"U must have 16 channels, got {U.shape[-1]}")
    if live is None:
        live = torch.ones(pts.shape[:1], dtype=torch.bool, device=pts.device)
    acc = _PackedSampleAcc.apply(U, pts, obs_min, obs_max, live.detach())
    return skel_from_acc(acc, pts)
