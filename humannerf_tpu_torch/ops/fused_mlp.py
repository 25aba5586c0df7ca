"""Fused non-rigid + canonical MLP point query
(counterpart of humannerf_tpu/ops/pallas_mlp.py).

The per-sample chain

    hannw-embed(x_skel) -> non-rigid MLP -> xyz -> fourier-embed(xyz)
      -> canonical MLP -> raw (rgb, sigma)

is the operation core of the renderer. `query_points_fused` is the wrapper
of the hand-written CUDA kernel `csrc/fused_mlp.cu` (`fused_mlp_forward`),
which replaces the Pallas TPU kernel `_fwd_call` / `_fwd_kernel`; it keeps
the whole chain in shared memory. In bfloat16 a block of a persistent grid
works on one liveness tile of `TILE` samples at a time with wgmma, its
weights streamed into shared memory by cp.async.bulk in the chunks that
`pack_kernel_weights` lays out; float32 works on half-tiles with
register-tiled fmaf, its weights streamed by cp.async in 16-row chunks of
the (in, out) matrices.
`query_points_plain` is its plain PyTorch version, built from models/mlps.py
and models/embedders.py. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.

Under autograd the CUDA route is a `torch.autograd.Function`: forward is the
kernel above, backward is `csrc/fused_mlp_bwd.cu` (`fused_mlp_backward`),
which replaces the Pallas TPU kernel `_bwd_call` / `_bwd_kernel`: it
recomputes the forward per tile of samples and returns dx and every dW and
db. The Function's inputs are the kernel's logical operands (slices of the
parameters, the first non-rigid bias with the condition code folded in), so
the gradients of the parameters' other parts, and of the condition code,
follow by autograd outside the kernel. The plain version of the backward is
autograd through `query_points_plain`. dW is summed with atomics: its last
bits vary from run to run.

On the card the kernel is bound by tensor-core operations: about 1.17 MFLOP
against 28 bytes a live sample at the default widths.

What carries over from the JAX kernel is what it computes: operand
rounding (bf16 operands, f32 accumulation, f32 bias and relu), the fold of
the per-frame condition code into the first non-rigid bias, the skip-layer
concat orders, and exact empty-space skipping -- a tile whose liveness
flag is 0 yields raw = 0, which composites to exactly what live computation
would, because the compositor multiplies alpha by fg. Its transposed
(3, N)/(4, N) boundary, freq-major row permutations and DMA schedule were
layout devices of the other machine and are not.
"""

from __future__ import annotations

import ctypes

import torch

from humannerf_tpu_torch.models import mlps
from humannerf_tpu_torch.models.embedders import (fourier_embed,
                                                  hann_window_weights,
                                                  hannw_fourier_embed)

TILE = 128          # samples per kernel tile == liveness granularity
_MAX_DEPTH = 12     # csrc/fused_mlp.cu MAX_DEPTH
_MAX_FREQ = 16      # csrc/fused_mlp.cu MAX_FREQ
_MAX_EPAD = 64      # csrc/fused_mlp.cu MAX_EPAD

# number of launches of the forward kernel and of the backward kernel
# (CUDA tensors only)
launches = 0
bwd_launches = 0


class Plan:
    """Static layer plan of the fused query (the JAX package's `Plan`)."""

    def __init__(self, *, nr_depth: int, nr_skips: tuple, nr_width: int,
                 nr_multires: int, cnl_depth: int, cnl_skips: tuple,
                 cnl_width: int, cnl_multires: int, skip_nr: bool,
                 compute_dtype):
        self.nr_depth = nr_depth
        self.nr_skips = set(nr_skips)
        self.nr_width = nr_width
        self.nr_multires = nr_multires
        self.nr_embed_dim = 6 * nr_multires
        self.cnl_depth = cnl_depth
        # reference convention: canonical layer li skips when (li-1) in skips
        self.cnl_skips = {s + 1 for s in cnl_skips}
        self.cnl_width = cnl_width
        self.cnl_multires = cnl_multires
        self.cnl_embed_dim = 3 + 6 * cnl_multires
        self.skip_nr = skip_nr
        self.compute_dtype = compute_dtype

    def n_tensors(self) -> int:
        n = 2 + 2   # cnl first + out
        for li in range(1, self.cnl_depth):
            n += 3 if li in self.cnl_skips else 2
        if not self.skip_nr:
            n += 2 + 2
            for i in range(1, self.nr_depth):
                n += 3 if i in self.nr_skips else 2
        return n

    def flops_per_sample(self) -> int:
        """Multiply-adds x 2 of one live sample's matrix products."""
        def net(e, w, depth, skips, n_out):
            macs = e * w + w * n_out
            for li in range(1, depth):
                macs += (w + (e if li in skips else 0)) * w
            return macs
        macs = net(self.cnl_embed_dim, self.cnl_width, self.cnl_depth,
                   self.cnl_skips, 4)
        if not self.skip_nr:
            macs += net(self.nr_embed_dim, self.nr_width, self.nr_depth,
                        self.nr_skips, 3)
        return 2 * macs


def plan_from_cfg(cfg, compute_dtype, skip_nr: bool) -> Plan | None:
    """A Plan when the config is the default model family, else None:
    plain 'mlp' non-rigid net, single-head canonical MLP with no extra
    input branches."""
    c, nr = cfg.canonical_mlp, cfg.non_rigid_motion_mlp
    eligible = (
        cfg.non_rigid_motion_model == "mlp"
        and cfg.multihead.head_num == 1
        and not c.view_dir and c.pose_color == "wo"
        and not c.input_encoder.enable and not c.time_input
        and c.condition_code_dim == 0
        and cfg.rgb_history.last_num == 0
        and cfg.condition_code.type == "global"
        and c.mlp_depth_plus == 0 and nr.mlp_depth_plus == 0
        and c.last_linear_scale == 1 and nr.last_linear_scale == 1
        and c.i_embed != -1 and nr.i_embed != -1
        and not nr.time_input
    )
    if not eligible:
        return None
    return Plan(
        nr_depth=nr.mlp_depth, nr_skips=tuple(nr.skips),
        nr_width=nr.mlp_width, nr_multires=nr.multires,
        cnl_depth=c.mlp_depth, cnl_skips=(4,), cnl_width=c.mlp_width,
        cnl_multires=c.multires, skip_nr=skip_nr,
        compute_dtype=compute_dtype)


def fold_condition_code(nr_params, embed_dim: int, condition_code):
    """First non-rigid layer with the per-frame condition code folded into
    its bias in float32: input order is [cc, pos_embed], so
    relu([cc, e] @ W0 + b0) == relu(e @ W0[cc_dim:] + (b0 + cc @ W0[:cc_dim])).
    Returns (W0[cc_dim:], folded bias)."""
    w0 = nr_params["block_mlps"][0]["w"]
    b0 = nr_params["block_mlps"][0]["b"]
    cc_dim = w0.shape[0] - embed_dim
    if condition_code is None:
        return w0[cc_dim:], b0
    cc = condition_code.reshape(-1).to(torch.float32)
    return w0[cc_dim:], b0 + cc @ w0[:cc_dim]


def _pad_rows(w, rows: int):
    if w.shape[0] == rows:
        return w
    pad = torch.zeros((rows - w.shape[0], w.shape[1]), dtype=w.dtype,
                      device=w.device)
    return torch.cat([w, pad], dim=0)


def kernel_operands(plan: Plan, nr_params, cnl_params, condition_code):
    """Parameter dictionaries -> the kernel's logical operands, float32
    views of the parameters in their own (in, out) layout and unpadded.

    Per net: w_h[i] the (width, width) rows that meet h, w_e[i] the
    (embed_dim, width) rows that meet the embedding, or None where a layer
    has no such operand; b[i]; w_out (width, n_out), b_out. The condition
    code is folded into the first non-rigid bias. Every entry is a
    differentiable function of the parameters and the condition code.
    """
    nets = {}
    if not plan.skip_nr:
        E = plan.nr_embed_dim
        layers = nr_params["block_mlps"]
        w0e, b0 = fold_condition_code(nr_params, E, condition_code)
        w_h, w_e, b = [None], [w0e], [b0]
        for i in range(1, plan.nr_depth):
            p = layers[i]
            if i in plan.nr_skips:        # input concat [h, pos_embed]
                w_h.append(p["w"][:plan.nr_width])
                w_e.append(p["w"][plan.nr_width:])
            else:
                w_h.append(p["w"])
                w_e.append(None)
            b.append(p["b"])
        nets["nr"] = dict(
            depth=plan.nr_depth, width=plan.nr_width,
            multires=plan.nr_multires, n_out=3, w_h=w_h, w_e=w_e, b=b,
            w_out=nr_params["output"]["w"], b_out=nr_params["output"]["b"])
    E = plan.cnl_embed_dim
    layers = cnl_params["pts_linears"]
    w_h, w_e, b = [None], [layers[0]["w"]], [layers[0]["b"]]
    for li in range(1, plan.cnl_depth):
        p = layers[li]
        if li in plan.cnl_skips:          # input concat [pos_embed, h]
            w_h.append(p["w"][E:])
            w_e.append(p["w"][:E])
        else:
            w_h.append(p["w"])
            w_e.append(None)
        b.append(p["b"])
    nets["cnl"] = dict(
        depth=plan.cnl_depth, width=plan.cnl_width,
        multires=plan.cnl_multires, n_out=4, w_h=w_h, w_e=w_e, b=b,
        w_out=cnl_params["output"]["w"], b_out=cnl_params["output"]["b"])
    return nets


CHUNK_ROWS = 64     # input rows of a bf16 weight chunk (128 bytes a column)


def _swizzle_index(n: int, device) -> torch.Tensor:
    """(n, 64) positions: entry (r, p) is the element that the 128-byte
    swizzle stores at position p of row r. Row r's 16-byte groups (8
    elements) are permuted by XOR with r % 8; the map is its own inverse."""
    r = torch.arange(n, device=device)[:, None]
    p = torch.arange(CHUNK_ROWS, device=device)[None, :]
    return ((p >> 3) ^ (r & 7)) * 8 + (p & 7)


def swizzled_chunks(w: torch.Tensor) -> torch.Tensor:
    """(K, N) matrix in (in, out) layout -> (ceil(K / 64), N, 64) bfloat16:
    chunk c holds input rows 64c .. 64c + 63 (zero past K) as N rows of 64,
    i.e. the transposed (out, in) block, each row of 128 bytes swizzled as
    wgmma's 128-byte-swizzle descriptors and the kernels' shared-memory
    layout expect. One chunk is what the kernels' producer copies into a
    stage with one cp.async.bulk; read K-major it is B of h W, read MN-major
    it is B of dy W^T."""
    K, N = w.shape
    C = -(-K // CHUNK_ROWS)
    wp = torch.zeros((C * CHUNK_ROWS, N), dtype=torch.bfloat16,
                     device=w.device)
    wp[:K] = w
    t = wp.reshape(C, CHUNK_ROWS, N).transpose(1, 2)    # t[c, n, k]
    return t.gather(2, _swizzle_index(N, w.device).expand(C, N, CHUNK_ROWS))


def pack_kernel_weights(plan: Plan, operands, backward: bool = False):
    """Logical operands -> the tensors the kernels read.

    Weight matrices are cast to the compute dtype once here; biases stay
    float32; everything is contiguous; w_e is zero-padded to a multiple of
    16 rows (`epad`). In bfloat16 the hidden-layer matrices w_h / w_e are
    `swizzled_chunks`; w_out stays (width, n_out). In float32 every matrix
    stays (in, out), and backward=True adds w_h_t / w_e_t, the (out, in)
    copies the float32 backward multiplies dy with: it streams their rows,
    so that dy W^T reads each chunk as the forward reads W's (bfloat16
    reads the chunks transposed: there they are lists of None).
    """
    dt = plan.compute_dtype
    chunked = dt == torch.bfloat16

    def aligned(t):
        # the kernels read operands as 8- to 32-byte words; a contiguous
        # view into a larger tensor may start anywhere
        t = t.contiguous()
        return t if t.data_ptr() % 32 == 0 else t.clone()

    def out_cast(w):
        return aligned(w.detach().to(dt))

    def hidden(w):
        if w is None:
            return None
        return swizzled_chunks(w.detach()) if chunked else out_cast(w)

    def f32(b):
        return aligned(b.detach().to(torch.float32))

    nets = {}
    for name, op in operands.items():
        edim = op["w_e"][0].shape[0]
        epad = -(-edim // 16) * 16
        w_e = [None if w is None else _pad_rows(w.detach(), epad)
               for w in op["w_e"]]
        net = dict(
            depth=op["depth"], width=op["width"], multires=op["multires"],
            epad=epad, edim=edim, n_out=op["n_out"],
            w_h=[hidden(w) for w in op["w_h"]],
            w_e=[hidden(w) for w in w_e],
            b=[f32(b) for b in op["b"]],
            w_out=out_cast(op["w_out"]), b_out=f32(op["b_out"]))
        if backward:
            if chunked:
                net["w_h_t"] = [None] * op["depth"]
                net["w_e_t"] = [None] * op["depth"]
            else:
                net["w_h_t"] = [None if w is None else out_cast(w.t())
                                for w in op["w_h"]]
                net["w_e_t"] = [None if w is None else out_cast(w.t())
                                for w in w_e]
        nets[name] = net
    return nets


def make_kernel_weights(plan: Plan, nr_params, cnl_params, condition_code):
    """Parameter dictionaries -> the forward kernel's operand lists (see
    `kernel_operands` and `pack_kernel_weights`). The result carries no
    autograd graph: prepare it once per frame when rendering."""
    return pack_kernel_weights(
        plan, kernel_operands(plan, nr_params, cnl_params, condition_code))


def ray_sort_order(fg_rs: torch.Tensor, skip_eps: float = 0.0):
    """(R, S) fg -> (order, inv): rays sorted by live-band centre.

    A ray's fg > eps samples form a contiguous z-band; after sorting rays by
    band centre, a z-major tile (many rays at one depth slot) is live only
    where the slot crosses the bands of the rays in its range, so dead
    tiles approach the per-sample ideal. Fully dead rays sort to the end.
    The sort is stable, like `jnp.argsort`."""
    R, S = fg_rs.shape
    live = fg_rs > skip_eps
    any_live = live.any(dim=1)
    li = live.to(torch.int32)
    s0 = torch.argmax(li, dim=1)
    s1 = S - torch.argmax(li.flip(1), dim=1)
    key = torch.where(any_live, s0 + s1, torch.full_like(s0, 2 * S + 2))
    order = torch.argsort(key, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(R, device=order.device, dtype=order.dtype)
    return order, inv


def tile_liveness(fg: torch.Tensor, skip_eps: float = 0.0) -> torch.Tensor:
    """(N,) fg -> (ceil(N / TILE),) int32: 1 where any sample of the tile
    has fg > skip_eps. The ragged tail counts as empty."""
    fg = fg.reshape(-1)
    n = fg.shape[0]
    pad = (-n) % TILE
    alive = fg > skip_eps
    if pad:
        alive = torch.cat([alive, torch.zeros((pad,), dtype=torch.bool,
                                              device=fg.device)])
    return alive.reshape(-1, TILE).any(dim=1).to(torch.int32)


def _expand_live(live, n):
    return torch.repeat_interleave(live > 0, TILE)[:n]


def query_points_plain(plan: Plan, params, x_skel, hann_alpha: float,
                       condition_code, live=None) -> torch.Tensor:
    """Plain PyTorch version of the fused query: x_skel (N, 3) -> raw (N, 4).

    embed -> apply_nonrigid_mlp -> embed -> apply_canonical_mlp on the whole
    batch, then the dead-tile zeroing the kernel does. `live`: optional
    (ceil(N / TILE),) int32 tile liveness.
    """
    x = x_skel.to(torch.float32)
    dt = plan.compute_dtype
    if plan.skip_nr:
        xyz = x
    else:
        nr = params["non_rigid_mlp"]
        cc_dim = nr["block_mlps"][0]["w"].shape[0] - plan.nr_embed_dim
        cc = condition_code if condition_code is not None else \
            torch.zeros((cc_dim,), dtype=torch.float32, device=x.device)
        e = hannw_fourier_embed(x, plan.nr_multires, hann_alpha)
        xyz = mlps.apply_nonrigid_mlp(
            nr, e, x, cc.reshape(-1), skips=tuple(plan.nr_skips),
            dtype=dt)["xyz"]
    embed = fourier_embed(xyz, plan.cnl_multires)
    raw = mlps.apply_canonical_mlp(
        params["cnl_mlp"], embed,
        skips=tuple(s - 1 for s in plan.cnl_skips), dtype=dt)
    if live is not None:
        alive = _expand_live(live, raw.shape[0])
        raw = torch.where(alive[:, None], raw, torch.zeros_like(raw))
    return raw


def _ptr_table(net, grads=None):
    """ctypes tables for one net: desc ints and the device-pointer list
    [w_h x MAX_DEPTH, w_e x MAX_DEPTH, b x MAX_DEPTH, w_out, b_out]; with
    `grads` (the backward's gradient buffers) followed by [w_h_t, w_e_t,
    dw_h, dw_e, db] x MAX_DEPTH, dw_out, db_out."""
    desc = (ctypes.c_int * 5)(net["depth"], net["width"], net["multires"],
                              net["epad"], net["n_out"])
    ptrs = [None] * (3 * _MAX_DEPTH + 2)
    for i in range(net["depth"]):
        for k, name in enumerate(("w_h", "w_e", "b")):
            t = net[name][i]
            ptrs[k * _MAX_DEPTH + i] = None if t is None else t.data_ptr()
    ptrs[3 * _MAX_DEPTH] = net["w_out"].data_ptr()
    ptrs[3 * _MAX_DEPTH + 1] = net["b_out"].data_ptr()
    if grads is not None:
        more = [None] * (5 * _MAX_DEPTH + 2)
        for i in range(net["depth"]):
            for k, t in enumerate((net["w_h_t"][i], net["w_e_t"][i],
                                   grads["w_h"][i], grads["w_e"][i],
                                   grads["b"][i])):
                more[k * _MAX_DEPTH + i] = None if t is None else t.data_ptr()
        more[5 * _MAX_DEPTH] = grads["w_out"].data_ptr()
        more[5 * _MAX_DEPTH + 1] = grads["b_out"].data_ptr()
        ptrs += more
    return desc, (ctypes.c_void_p * len(ptrs))(*ptrs)


def _check_plan_for_kernel(plan: Plan):
    if plan.compute_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"compute dtype {plan.compute_dtype} has no kernel")
    nets = [("canonical", plan.cnl_width, plan.cnl_depth, plan.cnl_embed_dim,
             plan.cnl_multires)]
    if not plan.skip_nr:
        nets.append(("non-rigid", plan.nr_width, plan.nr_depth,
                     plan.nr_embed_dim, plan.nr_multires))
    for name, width, depth, edim, multires in nets:
        if width % 64 or not 64 <= width <= 256:
            raise ValueError(
                f"fused_mlp kernel: {name} width {width} is not a multiple "
                f"of 64 in [64, 256]")
        if not 1 <= depth <= _MAX_DEPTH:
            raise ValueError(f"fused_mlp kernel: {name} depth {depth} is "
                             f"outside [1, {_MAX_DEPTH}]")
        if edim > _MAX_EPAD or multires > _MAX_FREQ:
            raise ValueError(f"fused_mlp kernel: {name} embedding of "
                             f"{edim} columns exceeds {_MAX_EPAD}")


def _check_call(plan: Plan, x_skel, live, nets):
    """Checks shared by the forward and the backward launch; returns the
    tile liveness (all ones when none was given)."""
    dev = x_skel.device
    if dev.type != "cuda":
        raise ValueError(f"the fused MLP kernels need CUDA tensors, got {dev}")
    if x_skel.dtype != torch.float32:
        raise TypeError(f"x_skel must be float32, got {x_skel.dtype}")
    if x_skel.dim() != 2 or x_skel.shape[1] != 3:
        raise ValueError(f"x_skel must be (N, 3), got {tuple(x_skel.shape)}")
    if not x_skel.is_contiguous():
        raise ValueError("x_skel must be contiguous")
    _check_plan_for_kernel(plan)
    n_tiles = -(-x_skel.shape[0] // TILE)
    if live is None:
        live = torch.ones((n_tiles,), dtype=torch.int32, device=dev)
    if (live.device != dev or live.dtype != torch.int32
            or tuple(live.shape) != (n_tiles,) or not live.is_contiguous()):
        raise ValueError(
            f"live must be a contiguous int32 ({n_tiles},) tensor on {dev}")
    for net in nets.values():
        for t in (net["w_h"] + net["w_e"] + net["b"]
                  + [net["w_out"], net["b_out"]]):
            if t is not None and t.device != dev:
                raise ValueError("parameters are on another device than "
                                 "x_skel")
    return live


def _library():
    from humannerf_tpu_torch.ops._build import load_library
    lib = load_library()
    if lib.fused_mlp_tile() != TILE or lib.fused_mlp_max_depth() != _MAX_DEPTH:
        raise RuntimeError("csrc/fused_mlp.cu and ops/fused_mlp.py disagree "
                           "on TILE / MAX_DEPTH")
    return lib


def _hann_table(plan: Plan, hann_alpha: float):
    hann = [0.0] * _MAX_FREQ
    if not plan.skip_nr:
        hann[:plan.nr_multires] = hann_window_weights(float(hann_alpha),
                                                      plan.nr_multires)
    return (ctypes.c_float * _MAX_FREQ)(*hann)


def _tile_counter(needed: bool, device):
    """A persistent grid (both backward kernels, the bfloat16 forward) takes
    its tiles from a counter that starts at zero on every launch; the
    float32 forward needs none."""
    return torch.zeros((1,), dtype=torch.int32, device=device) \
        if needed else None


def launch_forward(plan: Plan, x_skel, hann_alpha: float, live, nets):
    """The forward kernel on prepared operands: x_skel (N, 3) -> (N, 4)."""
    global launches
    live = _check_call(plan, x_skel, live, nets)
    dev = x_skel.device
    lib = _library()
    cnl_desc, cnl_ptrs = _ptr_table(nets["cnl"])
    nr_desc, nr_ptrs = (cnl_desc, cnl_ptrs) if plan.skip_nr \
        else _ptr_table(nets["nr"])
    n = x_skel.shape[0]
    out = torch.empty((n, 4), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    is_bf16 = plan.compute_dtype == torch.bfloat16
    next_tile = _tile_counter(is_bf16, dev)
    with torch.cuda.device(dev):
        err = lib.fused_mlp_forward(
            x_skel.data_ptr(), out.data_ptr(), n, live.data_ptr(),
            _hann_table(plan, hann_alpha), 1 if is_bf16 else 0,
            1 if plan.skip_nr else 0, nr_desc, nr_ptrs, cnl_desc, cnl_ptrs,
            None if next_tile is None else next_tile.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_forward failed to launch "
                           f"(cudaError {err})")
    launches += 1
    return out


def _grad_buffers(net, device):
    """Zeroed float32 gradient buffers of one net, views of one allocation:
    dw_h (width, width), dw_e (epad, width), db (width,) per layer, dw_out
    (width, n_out), db_out (n_out,)."""
    W, epad, n_out = net["width"], net["epad"], net["n_out"]
    shapes = []
    for i in range(net["depth"]):
        shapes.append(("w_h", i, (W, W) if net["w_h"][i] is not None else None))
        shapes.append(("w_e", i, (epad, W) if net["w_e"][i] is not None
                       else None))
        shapes.append(("b", i, (W,)))
    shapes += [("w_out", None, (W, n_out)), ("b_out", None, (n_out,))]
    total = sum(-(-int(torch.Size(sh).numel()) // 8) * 8
                for _, _, sh in shapes if sh is not None)
    flat = torch.zeros((total,), dtype=torch.float32, device=device)
    grads = {"w_h": [], "w_e": [], "b": []}
    off = 0
    for key, i, sh in shapes:
        t = None
        if sh is not None:
            numel = int(torch.Size(sh).numel())
            t = flat[off:off + numel].view(sh)
            off += -(-numel // 8) * 8          # keep every buffer 32-byte aligned
        if i is None:
            grads[key] = t
        else:
            grads[key].append(t)
    return grads


def launch_backward(plan: Plan, x_skel, g, hann_alpha: float, live, nets):
    """The backward kernel: g (N, 4), the cotangent of raw -> (dx (N, 3),
    {net: gradient buffers as `_grad_buffers` lays them out}). `nets` must
    come from `pack_kernel_weights(..., backward=True)`."""
    global bwd_launches
    live = _check_call(plan, x_skel, live, nets)
    dev = x_skel.device
    n = x_skel.shape[0]
    if (g.device != dev or g.dtype != torch.float32
            or tuple(g.shape) != (n, 4) or not g.is_contiguous()):
        raise ValueError(f"g must be a contiguous float32 ({n}, 4) tensor "
                         f"on {dev}")
    if "w_h_t" not in nets["cnl"]:
        raise ValueError("operands were packed without backward=True")
    lib = _library()
    grads = {name: _grad_buffers(net, dev) for name, net in nets.items()}
    cnl_desc, cnl_ptrs = _ptr_table(nets["cnl"], grads["cnl"])
    nr_desc, nr_ptrs = (cnl_desc, cnl_ptrs) if plan.skip_nr \
        else _ptr_table(nets["nr"], grads["nr"])
    dx = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return dx, grads
    is_bf16 = plan.compute_dtype == torch.bfloat16
    next_tile = _tile_counter(True, dev)
    with torch.cuda.device(dev):
        grid = lib.fused_mlp_bwd_grid(int(is_bf16))
        if grid <= 0:
            raise RuntimeError("fused_mlp_bwd_grid failed")
        grid = min(grid, -(-n // lib.fused_mlp_bwd_block_rows(int(is_bf16))))
        per_block = lib.fused_mlp_bwd_scratch_elems(
            int(is_bf16), 1 if plan.skip_nr else 0, nr_desc, cnl_desc)
        scratch = torch.empty((grid * per_block,), dtype=plan.compute_dtype,
                              device=dev)
        err = lib.fused_mlp_backward(
            x_skel.data_ptr(), g.data_ptr(), dx.data_ptr(), n,
            live.data_ptr(), _hann_table(plan, hann_alpha), int(is_bf16),
            1 if plan.skip_nr else 0, nr_desc, nr_ptrs, cnl_desc, cnl_ptrs,
            scratch.data_ptr(), per_block, grid, next_tile.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_backward failed to launch "
                           f"(cudaError {err})")
    bwd_launches += 1
    return dx, grads


def _flatten_operands(operands):
    """-> (slots, tensors): slots name each tensor as (net, key, layer)."""
    slots, flat = [], []
    for name, op in operands.items():
        for i in range(op["depth"]):
            for key in ("w_h", "w_e", "b"):
                if op[key][i] is not None:
                    slots.append((name, key, i))
                    flat.append(op[key][i])
        for key in ("w_out", "b_out"):
            slots.append((name, key, None))
            flat.append(op[key])
    return tuple(slots), flat


class _FusedQuery(torch.autograd.Function):
    """raw = fused query of x_skel. Inputs after x_skel: the logical operands
    flattened by `_flatten_operands`. Forward and backward each launch one
    kernel; hann window and liveness get no gradient."""

    @staticmethod
    def forward(ctx, plan, hann_alpha, live, slots, meta, x_skel, *flat):
        operands = {name: dict(m, w_h=[None] * m["depth"],
                               w_e=[None] * m["depth"], b=[None] * m["depth"])
                    for name, m in meta.items()}
        for (name, key, i), t in zip(slots, flat):
            if i is None:
                operands[name][key] = t
            else:
                operands[name][key][i] = t
        nets = pack_kernel_weights(plan, operands, backward=True)
        out = launch_forward(plan, x_skel, hann_alpha, live, nets)
        ctx.plan, ctx.hann_alpha, ctx.live = plan, hann_alpha, live
        ctx.slots, ctx.nets = slots, nets
        ctx.shapes = [tuple(t.shape) for t in flat]
        ctx.dtypes = [t.dtype for t in flat]
        ctx.save_for_backward(x_skel)
        return out

    @staticmethod
    def backward(ctx, g):
        x_skel, = ctx.saved_tensors
        dx, grads = launch_backward(ctx.plan, x_skel, g.contiguous(),
                                    ctx.hann_alpha, ctx.live, ctx.nets)
        dflat = []
        for (name, key, i), shape, dt in zip(ctx.slots, ctx.shapes,
                                             ctx.dtypes):
            t = grads[name][key] if i is None else grads[name][key][i]
            # rows of w_e past the embedding's width are the kernel's zero
            # padding: their gradient is dropped
            dflat.append(t[:shape[0]].to(dt))
        return (None, None, None, None, None, dx, *dflat)


def query_points_fused(plan: Plan, params, x_skel, hann_alpha: float,
                       condition_code, live=None,
                       kernel_weights=None) -> torch.Tensor:
    """Fused query: x_skel (N, 3) float32 contiguous -> raw (N, 4) float32.

    params: {'non_rigid_mlp': ..., 'cnl_mlp': ...} (the former unused when
    plan.skip_nr). hann_alpha: host float. condition_code: (cc_dim,) or
    None. live: optional (ceil(N / TILE),) int32 tile liveness (see
    `tile_liveness`); tiles flagged 0 yield zeros and cost no other work.
    kernel_weights: optional result of `make_kernel_weights` for these
    params and this condition code, to prepare the operands once per frame
    instead of once per call; such a call is forward only.

    CPU tensors go through `query_points_plain`; CUDA tensors launch the
    kernel (building it at first use) or raise. Without `kernel_weights`
    the call is differentiable: its backward launches the backward kernel.
    """
    if x_skel.device.type == "cpu":
        return query_points_plain(plan, params, x_skel, hann_alpha,
                                  condition_code, live)
    if x_skel.device.type != "cuda":
        raise ValueError(f"unsupported device {x_skel.device}")
    if condition_code is not None and condition_code.device != x_skel.device:
        raise ValueError("condition_code is on another device than x_skel")
    if kernel_weights is not None:
        return launch_forward(plan, x_skel, hann_alpha, live, kernel_weights)
    operands = kernel_operands(plan, params.get("non_rigid_mlp"),
                               params["cnl_mlp"], condition_code)
    slots, flat = _flatten_operands(operands)
    meta = {name: {k: op[k] for k in ("depth", "width", "multires", "n_out")}
            for name, op in operands.items()}
    if live is not None:
        live = live.detach()
    return _FusedQuery.apply(plan, float(hann_alpha), live, slots, meta,
                             x_skel, *flat)
