"""GlowTTS's flow WaveNet layer as one CUDA kernel (``csrc/flow_wn.cu``).

The JAX package leaves the coupling's WaveNet
(``larynx_tpu/models/glow_tts/flows.py::wavenet``) to XLA; there is no
Pallas kernel to port.  On the card, each layer of the reverse flow runs as
one launch of a float32 kernel (3xTF32 on wgmma, the port's float32 rule),
with the gate, the res/skip 1x1, the masked residual update and the skip
sum fused, where the torch route runs ~9 kernels.  One layer, for x
[B, T, h] (channels-last, zero where the mask is), mask [B, T]:

    a        = conv_d(x, w_in) + b_in (+ g, the row's speaker bias)    [B, T, 2h]
    act      = tanh(a[..., :h]) * sigmoid(a[..., h:])
    rs       = act @ w_rs + b_rs                                        [B, T, 2h]
    x_out    = (x + rs[..., :h]) * mask          (not on the last layer)
    skip_out = skip + rs[..., h:]                (first: rs[..., h:]; last: times mask)

with conv_d the k-tap conv of dilation d, zero-padded outside [0, T).  A
pair of 64-step tiles (:data:`TILE`, :data:`CLUSTER`) whose mask is zero on
every row writes zeros and does no products: the masked arithmetic gives
x_out = 0 there, and the stack's output, skip * mask, is 0 there whatever
skip holds.

Weights travel packed (:func:`pack_stack`, once, at load, by
``models/glow_tts/model.py::pack_params``): per layer the TF32 hi and lo
stages of [w_in taps; w_rs] in ``ops/wn_layer.py::pack_weights``'s layout,
where the geometry fits (:func:`packs`).  The coupling takes the kernel
where its weights were packed and the tensor is a CUDA float32 tensor that
needs no gradient (:func:`kernel_route`); bfloat16, float64, CPU tensors
and training keep the torch ops.  :func:`flow_wn_layer_plain` is the
kernel's arithmetic on the packed weights in plain torch, which the card's
checks compare the kernel with (:func:`check_stack` at :data:`CHECK_CASES`,
for ``tests/test_torch_flow_wn.py`` and ``chip_smoke.py``); the CPU route
never calls it.
"""

import ctypes
import typing

import torch
import torch.nn.functional as F

from larynx_tpu_torch.ops.wn_layer import pack_weights
from larynx_tpu_torch.runtime import trace

KERNEL_CHANNELS = 192  # h the kernel is built for (kCh)
MAX_TAPS = 5  # the widest conv it takes (kMaxTaps); any odd k up to it
TILE = 64  # time steps a block (kTile)
CLUSTER = 2  # blocks a cluster: neighbouring tiles, skipped together when masked
MODE_MID, MODE_FIRST, MODE_LAST, MODE_FIRST_LAST = range(4)


def packs(hidden: int, taps: int) -> bool:
    """Whether the kernel is built for a WaveNet of ``hidden`` channels and
    a ``taps``-tap conv."""
    return hidden == KERNEL_CHANNELS and taps % 2 == 1 and 1 <= taps <= MAX_TAPS


def kernel_route(device_type: str, dtype: torch.dtype, requires_grad: bool,
                 packed: bool) -> bool:
    """The routing rule: a WaveNet whose weights were packed runs on the
    kernel when its input is a CUDA float32 tensor that needs no gradient;
    anything else (bfloat16, float64, the CPU, training) on torch ops."""
    return packed and device_type == "cuda" and dtype == torch.float32 and not requires_grad


def pack_stack(in_w: torch.Tensor, rs_w: torch.Tensor) -> torch.Tensor:
    """One WaveNet's conv weights ``in_w`` [L, 2h, h, k] and res/skip 1x1s
    ``rs_w`` [L, 2h, h] -> the kernel's weight stages [L, n], float32: per
    layer the k taps' [h, 2h] products, then the [h, 2h] res/skip product,
    as TF32 hi and lo planes (``ops/wn_layer.py::pack_weights``)."""
    n_layers, _, h, k = in_w.shape
    if not packs(h, k):
        raise ValueError(f"the flow WN kernel takes h={KERNEL_CHANNELS} and odd k <= {MAX_TAPS}, "
                         f"got h={h}, k={k}")
    w = in_w.float()
    return torch.stack([
        pack_weights(torch.cat([w[i, :, :, j].t() for j in range(k)]), rs_w[i].float().t())
        for i in range(n_layers)])


def unpack_layer(wpack: torch.Tensor, taps: int, h: int = KERNEL_CHANNELS):
    """One layer's stages -> (w_a [taps * h, 2h], w_rs [h, 2h]), each the
    float32 sum of its hi and lo planes: the inverse of :func:`pack_stack`'s
    layout (``[stage][c][plane][ngrp][kgrp][r8][k4]``, one k-step of 8 rows
    a stage, consumer c owning 192 columns)."""
    def product(flat, k):
        v = flat.reshape(k // 8, 2, 2, h // 8, 2, 8, 4)  # stage, c, plane, ngrp, kgrp, r8, k4
        v = v.permute(2, 0, 4, 6, 1, 3, 5).reshape(2, k, 2 * h)  # plane, k, (c, n)
        return v[0] + v[1]

    split = taps * h * 2 * h * 2
    w_a = product(wpack[:split], taps * h)
    w_rs = product(wpack[split:], h)
    half = h // 2
    # the first product's columns: consumer c's tanh channels, then their sigmoid partners
    cols = torch.cat([torch.cat([torch.arange(c * half, (c + 1) * half),
                                 torch.arange(h + c * half, h + (c + 1) * half)])
                      for c in range(2)]).to(wpack.device)
    w_a = torch.empty_like(w_a).index_copy_(1, cols, w_a)
    return w_a, w_rs


def kept_tiles(mask: torch.Tensor) -> torch.Tensor:
    """[B, T] mask -> [B, T] 1.0 where the kernel computes the row (its pair
    of tiles has a row whose mask is not zero), 0.0 where it writes zeros."""
    b, t = mask.shape
    span = TILE * CLUSTER
    valid = F.pad((mask != 0).to(torch.float32), (0, -t % span))
    pairs = valid.reshape(b, -1, span).amax(dim=2)
    return pairs.repeat_interleave(span, dim=1)[:, :t].to(mask.dtype)


def _shifted(x: torch.Tensor, offset: int) -> torch.Tensor:
    """y[:, t] = x[:, t + offset], zero outside [0, T)."""
    t = x.shape[1]
    if abs(offset) >= t:
        return torch.zeros_like(x)
    if offset >= 0:
        return F.pad(x[:, offset:], (0, 0, 0, offset))
    return F.pad(x[:, :offset], (0, 0, -offset, 0))


def flow_wn_layer_plain(x, skip, mask, wpack, b_in, b_rs, g, taps: int, dilation: int,
                        first: bool, last: bool):
    """The kernel's arithmetic in plain torch -> (x_out or None on the last
    layer, skip_out): the products in float32 on the packed weights (hi +
    lo), the state updates masked as the kernel masks them, and the rows
    of skipped tile pairs zero.  ``g`` [B, 2h] or None; ``skip`` is not
    read when ``first``."""
    h = x.shape[-1]
    w_a, w_rs = unpack_layer(wpack, taps, h)
    a = b_in if g is None else b_in + g[:, None, :]
    half = (taps - 1) // 2
    for j in range(taps):
        a = a + _shifted(x, (j - half) * dilation) @ w_a[j * h : (j + 1) * h]
    act = torch.tanh(a[..., :h]) * torch.sigmoid(a[..., h:])
    rs = act @ w_rs + b_rs
    m = mask[..., None]
    keep = kept_tiles(mask)[..., None]
    x_out = None if last else (x + rs[..., :h]) * m * keep
    s = rs[..., h:] if first else skip + rs[..., h:]
    if last:
        s = s * m
    return x_out, s * keep


def wavenet_plain(p, x, mask, dilation_rate: int = 1, g=None) -> torch.Tensor:
    """:func:`wavenet` through :func:`flow_wn_layer_plain`, layer by layer."""
    n_layers, taps, two_h = p["flow_wn"].shape[0], p["in_w"].shape[-1], 2 * x.shape[-1]
    skip = None
    for i in range(n_layers):
        gi = None if g is None else g[:, 0, i * two_h : (i + 1) * two_h]
        x, skip = flow_wn_layer_plain(
            x, skip, mask, p["flow_wn"][i], p["in_b"][i], p["res_skip_b"][i], gi, taps,
            dilation_rate ** i, first=i == 0, last=i == n_layers - 1)
    return skip


# -----------------------------------------------------------------------------
# The kernel


def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use."""
    from larynx_tpu_torch.ops.build import load_library

    lib = load_library("flow_wn")
    if not hasattr(lib, "_larynx_ready"):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flow_wn_f32.restype = i
        lib.flow_wn_f32.argtypes = [p, p, p, p, p, p, ll, p, ll, ll, p, p, i, i, i, i, i, p]
        lib.flow_wn_error_string.restype = ctypes.c_char_p
        lib.flow_wn_error_string.argtypes = [i]
        lib.flow_wn_smem_bytes.restype = i
        lib.flow_wn_smem_bytes.argtypes = []
        lib._larynx_ready = True
    return lib


def _check(x, skip, mask, wpack, b_in, b_rs, g, taps, dilation):
    if x.dim() != 3 or x.shape[-1] != KERNEL_CHANNELS:
        raise ValueError(f"x must be [B, T, {KERNEL_CHANNELS}], got {tuple(x.shape)}")
    b, t, h = x.shape
    if not packs(h, taps) or dilation < 1:
        raise ValueError(f"no flow WN kernel for k={taps}, dilation={dilation}")
    if mask.shape != (b, t):
        raise ValueError(f"mask must be {(b, t)}, got {tuple(mask.shape)}")
    if wpack.numel() != 2 * (taps + 1) * h * 2 * h:
        raise ValueError("the packed weights do not match the layer's geometry")
    if skip is not None and skip.shape != x.shape:
        raise ValueError(f"skip must be {tuple(x.shape)}, got {tuple(skip.shape)}")
    if g is not None and (g.shape != (b, 2 * h) or g.stride(1) != 1):
        raise ValueError(f"g must be [B, {2 * h}] with unit channel stride, got {tuple(g.shape)}")
    dense = {"x": x, "skip": skip, "wpack": wpack, "b_in": b_in, "b_rs": b_rs}
    for name, v in list(dense.items()) + [("mask", mask), ("g", g)]:
        if v is not None and (v.device != x.device or v.dtype != torch.float32):
            raise TypeError(f"the flow WN kernel takes float32 tensors on {x.device}, "
                            f"{name} is {v.dtype} on {v.device}")
    for name, v in dense.items():
        if v is not None and not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if v is not None and v.data_ptr() % 16:  # TMA copies start on 16-byte boundaries
            raise ValueError(f"{name} must be 16-byte aligned")


def flow_wn_layer(x, skip, mask, wpack, b_in, b_rs, g, taps: int, dilation: int,
                  first: bool, last: bool, x_out: typing.Optional[torch.Tensor] = None):
    """One layer on the card (one launch) -> (x_out or None on the last
    layer, skip_out), arguments as :func:`flow_wn_layer_plain`'s.  skip_out
    is ``skip`` updated in place (a new tensor on the first layer); x_out
    is written into ``x_out`` when given (it must not be ``x``).  CUDA
    float32 tensors only; anything else raises."""
    if x.device.type != "cuda":
        raise ValueError(f"flow_wn_layer runs on CUDA tensors, got {x.device}")
    if first:
        skip = None
    elif skip is None:
        raise ValueError("skip is required unless first")
    _check(x, skip, mask, wpack, b_in, b_rs, g, taps, dilation)
    skip_out = torch.empty_like(x) if first else skip
    if last:
        x_out = None
    elif x_out is None:
        x_out = torch.empty_like(x)
    elif x_out.shape != x.shape or not x_out.is_contiguous() or x_out.data_ptr() == x.data_ptr():
        raise ValueError("x_out must be a contiguous tensor of x's shape apart from x")
    mode = {(False, False): MODE_MID, (True, False): MODE_FIRST,
            (False, True): MODE_LAST, (True, True): MODE_FIRST_LAST}[(first, last)]
    ptr = lambda v: None if v is None else v.data_ptr()  # noqa: E731
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.flow_wn_f32(
            x.data_ptr(), ptr(skip), wpack.data_ptr(), b_in.data_ptr(), b_rs.data_ptr(), ptr(g),
            0 if g is None else g.stride(0), mask.data_ptr(), mask.stride(0), mask.stride(1),
            ptr(x_out), skip_out.data_ptr(), x.shape[0], x.shape[1], taps, dilation, mode,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flow_wn launch failed: {lib.flow_wn_error_string(err).decode()}")
    trace.count("engine.flow_wn_kernel_layers")
    return x_out, skip_out


def wavenet(p, x, mask, dilation_rate: int = 1, g=None) -> torch.Tensor:
    """``models/glow_tts/flows.py::wavenet`` on the kernel, one launch a
    layer: ``p`` a coupling's WaveNet params with their packed stages
    (``p["flow_wn"]`` [L, n]), x [B, T, h], mask [B, T], ``g`` [B, 1, 2h * L]
    or None."""
    n_layers = p["flow_wn"].shape[0]
    taps = p["in_w"].shape[-1]
    two_h = 2 * x.shape[-1]
    x = x.contiguous()
    # the layers' outputs alternate between two buffers: a layer's x_out
    # must not be its x, and the caller's x is left as it is
    bufs = [torch.empty_like(x), torch.empty_like(x)] if n_layers > 1 else []
    skip = None
    for i in range(n_layers):
        gi = None if g is None else g[:, 0, i * two_h : (i + 1) * two_h]
        last = i == n_layers - 1
        x, skip = flow_wn_layer(
            x, skip, mask, p["flow_wn"][i], p["in_b"][i], p["res_skip_b"][i], gi, taps,
            dilation_rate ** i, first=i == 0, last=last, x_out=None if last else bufs[i % 2])
    return skip


# -----------------------------------------------------------------------------
# The card's checks (tests/test_torch_flow_wn.py, chip_smoke.py)

# (label, B, T' (squeezed steps), taps, dilation rate, g, row lengths): B = 8
# at ul_batch8's squeezed buckets (mel 768 / 1024 / 1536 / 2048), with rows
# that end mid-tile and pairs of tiles wholly padded; the stream's B = 1; a
# speaker bias; dilation 2; a narrower conv; a short sentence's one partial tile
CHECK_CASES = (
    ("main path, mel bucket 768", 8, 384, 5, 1, False, (384, 300, 257, 200, 129, 128, 64, 1)),
    ("main path, mel bucket 1024, g", 8, 512, 5, 1, True, (500, 450, 400, 333, 256, 130, 100, 2)),
    ("main path, mel bucket 1536", 8, 768, 5, 1, False, (768, 700, 640, 500, 420, 380, 300, 250)),
    ("main path, mel bucket 2048", 8, 1024, 5, 1, False,
     (1000, 900, 700, 650, 600, 500, 400, 300)),
    ("stream, B=1, mel bucket 1024", 1, 512, 5, 1, False, (437,)),
    ("stream, B=1, mel bucket 768", 1, 384, 5, 1, False, (337,)),
    ("dilation rate 2, g", 3, 300, 5, 2, True, (300, 140, 10)),
    ("k=3, dilation rate 2", 2, 200, 3, 2, False, (200, 70)),
    ("under one tile, B=2, mel bucket 64", 2, 32, 5, 1, True, (32, 17)),
)
# 3xTF32 products against float32 ones over K = 960 (the conv) and 192 (the
# res/skip 1x1): the largest error relative to each output's scale.  A
# layout, tap, mask or skipped-tile fault is O(1) of the scale.
CHECK_TOLERANCE = 2e-5


def random_stack(taps: int, seed: int, layers: int = 4, device="cpu"):
    """A WaveNet's params at the published init's scale (uniform
    1/sqrt(fan_in)), the last layer's res half zero (it emits its skip
    alone), with its packed stages."""
    gen = torch.Generator().manual_seed(seed)
    h = KERNEL_CHANNELS

    def u(*shape, fan_in):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) / fan_in ** 0.5).to(device)

    p = {"in_w": u(layers, 2 * h, h, taps, fan_in=h * taps),
         "in_b": u(layers, 2 * h, fan_in=h * taps),
         "res_skip_w": u(layers, 2 * h, h, fan_in=h), "res_skip_b": u(layers, 2 * h, fan_in=h)}
    p["res_skip_w"][-1, :h] = 0.0
    p["res_skip_b"][-1, :h] = 0.0
    return dict(p, flow_wn=pack_stack(p["in_w"], p["res_skip_w"]))


def random_inputs(lengths, t: int, seed: int, with_g: bool = False, layers: int = 4,
                  device="cpu"):
    """(x [B, T, h] zero past each row's length, the prefix mask [B, T], g
    [B, 1, 2h * layers] or None) for rows of ``lengths``."""
    gen = torch.Generator().manual_seed(seed)
    mask = (torch.arange(t)[None] < torch.tensor(lengths)[:, None]).float()
    x = torch.randn(len(lengths), t, KERNEL_CHANNELS, generator=gen) * mask[..., None]
    g = torch.randn(len(lengths), 1, 2 * KERNEL_CHANNELS * layers, generator=gen) if with_g \
        else None
    return x.to(device), mask.to(device), None if g is None else g.to(device)


def check_stack(p, x, mask, g, dilation_rate: int) -> float:
    """Each layer of the stack on the kernel against :func:`flow_wn_layer_plain`,
    both from the plain version's inputs -> the largest error relative to
    each output's scale.  Raises unless each layer is one launch (read from
    ``engine.flow_wn_kernel_layers``)."""
    n_layers, taps, two_h = p["flow_wn"].shape[0], p["in_w"].shape[-1], 2 * x.shape[-1]
    err, skip = 0.0, None
    for i in range(n_layers):
        gi = None if g is None else g[:, 0, i * two_h : (i + 1) * two_h]
        args = (mask, p["flow_wn"][i], p["in_b"][i], p["res_skip_b"][i], gi, taps,
                dilation_rate ** i, i == 0, i == n_layers - 1)
        want = flow_wn_layer_plain(x, skip, *args)
        before = trace.counters().get("engine.flow_wn_kernel_layers", 0)
        got = flow_wn_layer(x, None if skip is None else skip.clone(), *args)
        launched = trace.counters().get("engine.flow_wn_kernel_layers", 0) - before
        if launched != 1:
            raise AssertionError(f"layer {i}: {launched} kernel launches, not one")
        for k, w in zip(got, want):
            if w is not None:
                err = max(err, float((k - w).abs().max()) / float(w.abs().max()))
        x, skip = want
    return err
