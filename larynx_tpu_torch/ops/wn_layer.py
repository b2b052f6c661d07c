"""Fused WaveGlow WN layer.

Counterpart of ``larynx_tpu/ops/wn_layer.py``: both its Pallas kernels,
``fused_wn_layer_state`` (the layer plus the residual/skip state update,
the production path of ``models/waveglow/model.py::_wn``) and
``fused_wn_layer`` (the layer alone, returning rs).  Both wrappers launch
a CUDA kernel for a CUDA tensor, ``csrc/wn_layer.cu`` in float32 and
``csrc/wn_bf16.cu`` in bfloat16, and run the plain torch version
(:func:`wn_layer_state_plain`, :func:`wn_layer_plain`) for a CPU tensor.
There is no other route: a CUDA tensor the kernel cannot take raises.

One layer, for h [B, T, ch], cond [B, T, cc] (channels-last):

    a   = conv_d(h, w_in) + cond @ w_cond + (b_in + b_cond)     [B, T, 2ch]
    g   = tanh(a[..., :ch]) * sigmoid(a[..., ch:])               [B, T, ch]
    rs  = g @ w_rs + b_rs                                        [B, T, rs_out]

with conv_d the k=3 conv of dilation d, zero-padded outside [0, T).  The
state update: ``h += rs[..., :ch]`` and ``skip += rs[..., ch:]``, except on
the last layer (rs_out == ch), where h passes through and all of rs is
skip; on the first layer ``skip = s``.

Weights travel packed (:func:`pack_wn_layer`, once, at load) in a
:class:`WNLayer`: the torch-layout tensors for the plain version, the folded
bias, and, where the kernel takes the geometry (ch = 256, cc a multiple of
32 in float32, of 64 in bfloat16), the kernel's weight stages in the wgmma
operand order that its TMA ring reads (:func:`pack_weights`): exact TF32 hi
and lo planes for float32, one plane for bfloat16.

Two element types: float32, and bfloat16, the JAX engine's vocoder
precision on an accelerator.  In bfloat16 the kernel and the plain version
round where the Pallas kernel does (``larynx_tpu/ops/wn_layer.py:155-195``):
the products sum in float32, ``bias_a = bf16(b_in + b_cond)``, the gate is
formed in float32 and rounded before the res/skip product, ``rs + b_rs`` is
rounded, and so are ``h + rs[..., :ch]`` and ``skip + rs[..., ch:]``.

The bfloat16 kernel runs persistent clusters (:func:`bf16_launch_plan`
mirrors its plan): as many clusters of :data:`BF16_CLUSTER` blocks as fit
on the card at once, each walking items of :data:`BF16_CLUSTER` 64-row
tiles and multicasting every weight stage to its blocks.
"""

import ctypes
import dataclasses
import typing

import torch
import torch.nn.functional as F

from larynx_tpu_torch.ops.mrf_block import _tf32_split

KERNEL_CHANNELS = 256  # ch the kernels are built for (kCh)
STAGE_BYTES = 32768  # one weight stage of the kernel's ring, float32 (Geom::kBStageBytes)
STAGE_BYTES_BF16 = 16384  # ... bfloat16 (csrc/wn_bf16.cu kBStageBytes)
CONSUMERS = 2  # consumer warpgroups, each owning a half of every product's columns
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# csrc/wn_bf16.cu's plan
BF16_TILE = 64  # time steps a tile (kTile)
BF16_CLUSTER = 2  # blocks a cluster, sharing each weight stage (kCluster)
BF16_RING_STAGES = 8  # weight ring depth (kBStages)
BF16_CHUNK_BYTES = BF16_TILE * 128  # one activation chunk (kChunkBytes)
# 1 KB of alignment, the activation ring (4 chunks, later the gated tile),
# the centre tap of h and the skip tile (4 chunks each), the weight ring,
# 27 mbarriers
BF16_SMEM_BYTES = (1024 + 12 * BF16_CHUNK_BYTES + BF16_RING_STAGES * STAGE_BYTES_BF16
                   + (2 * BF16_RING_STAGES + 2 * 4 + 3) * 8)

# kernel modes (csrc/wn_layer.cu Mode)
MODE_RS, MODE_MID, MODE_FIRST, MODE_LAST, MODE_FIRST_LAST = range(5)


@dataclasses.dataclass(frozen=True)
class WNLayer:
    """One WN layer's weights: ``w_in`` [2ch, ch, 3] (conv), ``w_cond``
    [2ch, cc], ``bias_a`` = b_in + b_cond [2ch], ``w_rs`` [rs_out, ch],
    ``b_rs`` [rs_out]; ``wpack`` the kernel's weight stages of
    [w_in taps; w_cond] and w_rs (:func:`pack_weights`; None where the
    kernel does not take the geometry); all in the params' dtype."""

    w_in: torch.Tensor
    w_cond: torch.Tensor
    bias_a: torch.Tensor
    w_rs: torch.Tensor
    b_rs: torch.Tensor
    wpack: typing.Optional[torch.Tensor]


def cond_align(dtype: torch.dtype = torch.float32) -> int:
    """The kernel's K chunk, which cc must be a multiple of: 128 bytes of
    channels (32 float32, 64 bfloat16)."""
    return 128 // dtype.itemsize


def kernel_takes(ch: int, cc: int, dtype: torch.dtype = torch.float32) -> bool:
    """True when the CUDA kernel is built for this (ch, cc, dtype)."""
    return (dtype in KERNEL_DTYPES and ch == KERNEL_CHANNELS and cc > 0
            and cc % cond_align(dtype) == 0)


def bf16_launch_plan(b: int, t: int, cc: int, rs_out: int, active_clusters: int) -> dict:
    """The bfloat16 kernel's launch at (B, T, cc, rs_out) on a card where
    ``active_clusters`` clusters fit at once (the kernel reports it:
    :func:`bf16_geometry`).  ``grid`` blocks in clusters of ``cluster``;
    an item is ``cluster`` consecutive 64-row tiles of the B * ceil(T / 64),
    row major (the last item may run past them on zero-filled rows); each
    block takes at most ``tiles_per_block`` tiles.  Every weight stage
    (``stage_bytes``, ``stages_per_tile`` of them a tile, ``ring_stages`` in
    flight) leaves L2 once an item: ``l2_weight_bytes`` a launch."""
    if not (1 <= b <= 65535 and t >= 1 and cc > 0 and cc % cond_align(torch.bfloat16) == 0
            and rs_out in (KERNEL_CHANNELS, 2 * KERNEL_CHANNELS) and active_clusters >= 1):
        raise ValueError(f"no bf16 WN plan for B={b}, T={t}, cc={cc}, rs_out={rs_out}, "
                         f"{active_clusters} clusters")
    tiles = b * -(-t // BF16_TILE)
    items = -(-tiles // BF16_CLUSTER)
    clusters = min(items, active_clusters)
    ch = KERNEL_CHANNELS
    kps2 = 1 if rs_out == 2 * ch else 2  # second-product k-steps a stage
    stages = (3 * ch + cc) // 16 + ch // 16 // kps2
    return {
        "tiles": tiles, "items": items, "cluster": BF16_CLUSTER, "clusters": clusters,
        "grid": clusters * BF16_CLUSTER, "tiles_per_block": -(-items // clusters),
        "stage_bytes": STAGE_BYTES_BF16, "stages_per_tile": stages,
        "ring_stages": BF16_RING_STAGES, "smem_bytes": BF16_SMEM_BYTES,
        "l2_weight_bytes": items * stages * STAGE_BYTES_BF16,
    }


def _stages(w: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """[K, N] -> the kernel's stages of one product, flat, in w's dtype.
    ``cols`` [CONSUMERS, n] lists the columns of W that consumer c owns, in
    its wgmma column order.

    float32: order ``[stage][j][c][plane][ngrp][kgrp][r8][k4]``: ``kps``
    k-steps of 8 rows per stage (as many as fill STAGE_BYTES), plane 0 the
    TF32 hi and 1 the lo of W, element = plane(W[8*(stage*kps + j) + 4*kgrp
    + k4, cols[c, 8*ngrp + r8]]).  Each (j, c, plane) block is a K-major
    wgmma B operand without swizzle: core matrices of 8 columns x 16 bytes
    of k (128 bytes), the two k halves adjacent, 8-column groups 256 bytes
    apart.

    bfloat16: one plane, k-steps of 16 rows, STAGE_BYTES_BF16 a stage:
    ``[stage][j][c][ngrp][kgrp][r8][k8]``, element = W[16*(stage*kps + j) +
    8*kgrp + k8, cols[c, 8*ngrp + r8]].
    """
    k = w.shape[0]
    n = cols.shape[1]
    if w.dtype == torch.bfloat16:
        kps = STAGE_BYTES_BF16 // (CONSUMERS * n * 16 * 2)
        if k % (16 * kps) or n % 8:
            raise ValueError(f"_stages takes K a multiple of {16 * kps}, got {tuple(w.shape)}")
        v = w[:, cols.reshape(-1)].contiguous().reshape(k // (16 * kps), kps, 2, 8, CONSUMERS,
                                                        n // 8, 8)
        # (stage, j, kgrp, k8, c, ngrp, r8) -> (stage, j, c, ngrp, kgrp, r8, k8)
        return v.permute(0, 1, 4, 5, 2, 6, 3).contiguous().reshape(-1)
    kps = STAGE_BYTES // (CONSUMERS * 2 * n * 8 * 4)
    if k % (8 * kps) or n % 8:
        raise ValueError(f"_stages takes K a multiple of {8 * kps}, got {tuple(w.shape)}")
    hi, lo = _tf32_split(w[:, cols.reshape(-1)].float().contiguous())
    v = torch.stack([hi, lo]).reshape(2, k // (8 * kps), kps, 2, 4, CONSUMERS, n // 8, 8)
    # (plane, stage, j, kgrp, k4, c, ngrp, r8) -> (stage, j, c, plane, ngrp, kgrp, r8, k4)
    return v.permute(1, 2, 5, 0, 6, 3, 7, 4).contiguous().reshape(-1)


def pack_weights(w_a: torch.Tensor, w_rs: torch.Tensor) -> torch.Tensor:
    """The kernel's weight stages, flat, in the weights' dtype: the first
    product's W_a [K, 2ch]
    (K = 3ch + cc rows, the conv taps for offsets -d, 0, +d then the cond
    1x1) and then the second product's W_rs [ch, rs_out], each in
    :func:`_stages` order.

    First product: consumer c owns channels [c*ch/2, (c+1)*ch/2), its
    columns those channels' tanh columns and then their sigmoid columns
    (ch + channel), so each consumer forms its gate in registers.  Second
    product: consumer c owns rs columns [c*rs_out/2, (c+1)*rs_out/2).
    """
    ch = w_rs.shape[0]
    half = ch // CONSUMERS
    cols_a = torch.stack([
        torch.cat([torch.arange(c * half, (c + 1) * half),
                   torch.arange(ch + c * half, ch + (c + 1) * half)])
        for c in range(CONSUMERS)
    ]).to(w_a.device)
    cols_rs = torch.arange(w_rs.shape[1], device=w_rs.device).reshape(CONSUMERS, -1)
    return torch.cat([_stages(w_a, cols_a), _stages(w_rs, cols_rs)])


def pack_wn_layer(
    in_w: torch.Tensor,
    in_b: torch.Tensor,
    cond_w: torch.Tensor,
    cond_b: torch.Tensor,
    rs_w: torch.Tensor,
    rs_b: torch.Tensor,
) -> WNLayer:
    """One layer's torch-layout params -> :class:`WNLayer`, on their device
    and in their dtype (bfloat16: ``bias_a`` is the bfloat16 sum).

    ``in_w`` [2ch, ch, 3]; ``cond_w`` [2ch, cc] / ``cond_b`` [2ch] are the
    layer's rows of the stack's conditioning 1x1; ``rs_w`` [rs_out, ch].
    """
    two_ch, ch, _k = in_w.shape
    cc = cond_w.shape[-1]
    wpack = None
    if kernel_takes(ch, cc, in_w.dtype) and in_w.shape[-1] == 3:
        taps = [in_w[:, :, tap].t() for tap in range(3)]  # [ch, 2ch] each
        wpack = pack_weights(torch.cat(taps + [cond_w.t()], dim=0), rs_w.t())
    return WNLayer(in_w, cond_w, (in_b + cond_b).contiguous(), rs_w, rs_b, wpack)


# -----------------------------------------------------------------------------
# Plain versions


def _gated(h, cond, w_in, w_cond, bias_a, dilation):
    """The gate of one layer; bfloat16 inputs run on float32 copies (exact
    products, float32 sums) and the gate is rounded to bfloat16."""
    if h.dtype == torch.bfloat16:
        g = _gated(h.float(), cond.float(), w_in.float(), w_cond.float(), bias_a.float(),
                   dilation)
        return g.to(torch.bfloat16)
    k = w_in.shape[-1]
    a = F.conv1d(h.transpose(1, 2), w_in, None, padding=(k - 1) // 2 * dilation,
                 dilation=dilation).transpose(1, 2)
    a = a + F.linear(cond, w_cond) + bias_a
    ch = h.shape[-1]
    return torch.tanh(a[..., :ch]) * torch.sigmoid(a[..., ch:])


def wn_layer_plain(h, cond, w_in, w_cond, bias_a, w_rs, b_rs, dilation: int) -> torch.Tensor:
    """rs [B, T, rs_out] of one layer, in plain torch (bfloat16: the gate
    and rs + b_rs rounded, the product in float32)."""
    g = _gated(h, cond, w_in, w_cond, bias_a, dilation)
    if g.dtype == torch.bfloat16:
        return F.linear(g.float(), w_rs.float(), b_rs.float()).to(torch.bfloat16)
    return F.linear(g, w_rs, b_rs)


def wn_layer_state_plain(
    h, cond, skip, w_in, w_cond, bias_a, w_rs, b_rs, dilation: int,
    first: bool = False, last: bool = False,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """(h_new, skip_new) of one layer, in plain torch; ``skip`` is ignored
    (may be None) when ``first``.  The state adds run in the tensors' dtype
    (bfloat16: rounded, as torch rounds a bfloat16 sum)."""
    ch = h.shape[-1]
    rs = wn_layer_plain(h, cond, w_in, w_cond, bias_a, w_rs, b_rs, dilation)
    if last:
        h_new, s = h, rs
    else:
        h_new, s = h + rs[..., :ch], rs[..., ch:]
    return h_new, (s if first else skip + s)


# -----------------------------------------------------------------------------
# Kernel wrappers


def _check(h, cond, skip, layer: WNLayer, rs_out: int, dilation: int) -> None:
    if h.dim() != 3 or cond.dim() != 3 or cond.shape[:2] != h.shape[:2]:
        raise ValueError(
            f"h must be [B, T, ch] and cond [B, T, cc], got {tuple(h.shape)}, {tuple(cond.shape)}"
        )
    ch, cc = h.shape[-1], cond.shape[-1]
    dtype = h.dtype
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"wn_layer kernel takes float32 or bfloat16, h is {dtype}")
    if not kernel_takes(ch, cc, dtype):
        raise NotImplementedError(
            f"wn_layer kernel takes ch={KERNEL_CHANNELS} and cc a multiple of "
            f"{cond_align(dtype)}, got ch={ch}, cc={cc}"
        )
    if layer.wpack is None:
        raise ValueError("the layer was packed without the kernel's weights")
    if rs_out not in (ch, 2 * ch):
        raise ValueError(f"rs_out must be {ch} or {2 * ch}, got {rs_out}")
    if dilation < 1:
        raise ValueError(f"dilation must be >= 1, got {dilation}")
    tensors = [("h", h), ("cond", cond), ("wpack", layer.wpack), ("bias_a", layer.bias_a),
               ("b_rs", layer.b_rs)]
    if skip is not None:
        if skip.shape != h.shape:
            raise ValueError(f"skip must be {tuple(h.shape)}, got {tuple(skip.shape)}")
        tensors.append(("skip", skip))
    for name, t in tensors:
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
        if t.dtype != dtype:
            raise TypeError(
                f"wn_layer kernel takes every tensor float32 or every tensor bfloat16, got h "
                f"{dtype}, {name} {t.dtype}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:  # TMA copies start on 16-byte boundaries
            raise ValueError(f"{name} must be 16-byte aligned")
    planes = 2 if dtype == torch.float32 else 1
    if layer.wpack.numel() != planes * ((3 * ch + cc) * 2 * ch + ch * rs_out):
        raise ValueError("the packed weights do not match the layer's geometry")


def _setup(name: str, lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = getattr(lib, "wn_bf16" if name == "wn_bf16" else "wn_layer_f32")
    launch.restype = i
    launch.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
    getattr(lib, f"{name}_error_string").argtypes = [i]
    if name == "wn_bf16":
        lib.wn_bf16_geometry.restype = i
        lib.wn_bf16_geometry.argtypes = [i, i, i, i, p]
    else:
        lib.wn_layer_smem_bytes.restype = i
        lib.wn_layer_smem_bytes.argtypes = []


def _library(dtype: torch.dtype = torch.float32) -> ctypes.CDLL:
    """The float32 kernel's library (``wn_layer``) or the bfloat16
    kernel's (``wn_bf16``), built at first use."""
    from larynx_tpu_torch.ops.build import load_library

    name = "wn_bf16" if dtype == torch.bfloat16 else "wn_layer"
    lib = load_library(name)
    if not hasattr(lib, "_larynx_ready"):
        _setup(name, lib)
        lib._larynx_ready = True
    return lib


def bf16_geometry(b: int, t: int, cc: int, rs_out: int) -> typing.List[int]:
    """The bfloat16 kernel's own launch plan on the current CUDA device:
    [grid blocks, cluster size, clusters that fit at once, tiles a block,
    weight stage bytes, weight stages a tile, ring stages, dynamic shared
    memory bytes] (mirrored by :func:`bf16_launch_plan`)."""
    lib = _library(torch.bfloat16)
    out = (ctypes.c_int * 8)()
    err = lib.wn_bf16_geometry(b, t, cc, rs_out, ctypes.addressof(out))
    if err != 0:
        raise ValueError(f"wn_bf16_geometry: {lib.wn_bf16_error_string(err).decode()}")
    return list(out)


def bf16_active_clusters() -> int:
    """Clusters of the bfloat16 kernel that fit on the current CUDA device
    at once."""
    return bf16_geometry(1, 1, cond_align(torch.bfloat16), 2 * KERNEL_CHANNELS)[2]


def _launch(lib, mode, h, cond, skip, layer, dilation, h_out, skip_out, rs):
    b, t, _ = h.shape
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(h.device).cuda_stream
    bf16 = h.dtype == torch.bfloat16
    launch = lib.wn_bf16 if bf16 else lib.wn_layer_f32
    with torch.cuda.device(h.device):
        err = launch(
            h.data_ptr(), cond.data_ptr(), ptr(skip), layer.wpack.data_ptr(),
            layer.bias_a.data_ptr(), layer.b_rs.data_ptr(), ptr(h_out), ptr(skip_out), ptr(rs),
            b, t, cond.shape[-1], layer.b_rs.numel(),
            dilation, mode, stream,
        )
    if err != 0:
        text = (lib.wn_bf16_error_string if bf16 else lib.wn_layer_error_string)(err)
        raise RuntimeError(f"wn_layer launch failed: {text.decode()}")


def fused_wn_layer_state(
    h: torch.Tensor,
    cond: torch.Tensor,
    skip: typing.Optional[torch.Tensor],
    layer: WNLayer,
    dilation: int,
    first: bool = False,
    last: bool = False,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """One WN layer with its state update -> (h_new, skip_new).

    A CPU tensor runs :func:`wn_layer_state_plain`; a CUDA tensor launches
    the kernel (one launch) or raises.  h_new is a new tensor (neighbouring
    time tiles read h's halo), or h itself on the last layer; skip_new is a
    new tensor.  ``skip`` may be None when ``first``.
    """
    ch = h.shape[-1]
    rs_out = layer.b_rs.numel()
    if last != (rs_out == ch):
        raise ValueError(f"last={last} but rs_out={rs_out} with ch={ch}")
    if not first and skip is None:
        raise ValueError("skip is required unless first")
    if h.device.type == "cpu":
        return wn_layer_state_plain(
            h, cond, skip, layer.w_in, layer.w_cond, layer.bias_a, layer.w_rs, layer.b_rs,
            dilation, first, last,
        )
    if h.device.type != "cuda":
        raise ValueError(f"fused_wn_layer_state runs on cpu or cuda tensors, got {h.device}")
    skip_in = None if first else skip
    _check(h, cond, skip_in, layer, rs_out, dilation)
    lib = _library(h.dtype)
    mode = {(False, False): MODE_MID, (True, False): MODE_FIRST,
            (False, True): MODE_LAST, (True, True): MODE_FIRST_LAST}[(first, last)]
    h_new = h if last else torch.empty_like(h)
    skip_new = torch.empty_like(h)
    _launch(lib, mode, h, cond, skip_in, layer, dilation, None if last else h_new, skip_new, None)
    fused_wn_layer_state.launches += 1
    return h_new, skip_new


fused_wn_layer_state.launches = 0  # kernel launches made by fused_wn_layer_state


def fused_wn_layer(
    h: torch.Tensor, cond: torch.Tensor, layer: WNLayer, dilation: int
) -> torch.Tensor:
    """One WN layer -> rs [B, T, rs_out], without the state update.

    A CPU tensor runs :func:`wn_layer_plain`; a CUDA tensor launches the
    kernel (one launch) or raises.
    """
    if h.device.type == "cpu":
        return wn_layer_plain(
            h, cond, layer.w_in, layer.w_cond, layer.bias_a, layer.w_rs, layer.b_rs, dilation
        )
    if h.device.type != "cuda":
        raise ValueError(f"fused_wn_layer runs on cpu or cuda tensors, got {h.device}")
    rs_out = layer.b_rs.numel()
    _check(h, cond, None, layer, rs_out, dilation)
    lib = _library(h.dtype)
    rs = torch.empty(h.shape[:2] + (rs_out,), dtype=h.dtype, device=h.device)
    _launch(lib, MODE_RS, h, cond, None, layer, dilation, None, None, rs)
    fused_wn_layer.launches += 1
    return rs


fused_wn_layer.launches = 0  # kernel launches made by fused_wn_layer
