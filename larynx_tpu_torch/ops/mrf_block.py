"""Fused multi-receptive-field (MRF) section of a HiFi-GAN stage.

Counterpart of ``larynx_tpu/ops/mrf_block.py::fused_mrf`` (both its dense
and its time-packed Pallas kernels).  ``mrf_section`` launches the CUDA
kernel ``csrc/mrf_section.cu`` once per resblock unit for a CUDA tensor and
runs ``mrf_section_plain``, the same function in plain torch, for a CPU
tensor.  There is no other route: a CUDA tensor the kernel cannot take
raises.

Weights travel packed (:func:`pack_mrf_weights`): every conv of the section
in execution order (chain r, unit u, dilated conv then, for ResBlock1, the
plain conv), taps ``[k][C_in][C_out]``, flattened into one buffer of the
params' dtype, with the biases as ``[n_convs, C]``.  The kernel reads the
weights as stages in wgmma operand order (:func:`pack_stages`): TF32 hi/lo
planes for float32, one plane for bfloat16.  :func:`pack_mrf_stage` builds
both layouts once, when the weights are loaded, into the :class:`MRFStage`
that ``mrf_section`` takes.

Two element types: float32, and bfloat16, the JAX engine's vocoder
precision on an accelerator.  In bfloat16 the kernel and the plain version
round where the Pallas kernel does (``larynx_tpu/ops/mrf_block.py:105-148``):
each conv sums in float32, adds its bias and is rounded to bfloat16; the
leaky-ReLU multiplies by bfloat16(0.1) and rounds; ``h + conv`` is rounded;
the chains' sum stays float32 until ``total / n_chains`` is rounded once.

The kernel's geometry, mirrored here so the CPU tests reach it: a block's
first conv computes ``TILE_ROWS`` rows, so a ResBlock1 unit's block yields
``TILE_ROWS - (k - 1)`` output rows (:func:`unit_stride`) from a raw input
tile of ``TILE_ROWS + (k - 1) * d`` rows (:func:`unit_rows`).
"""

import ctypes
import dataclasses
import typing

import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.1
LRELU_SLOPE_BF16 = 0.10009765625  # bfloat16(0.1): JAX's slope in bfloat16 (csrc kSlopeBf16)
KERNEL_CHANNELS = (8, 16, 32, 64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# csrc/mrf_section.cu geometry
TILE_ROWS = 128  # kM: first-conv rows per block (two wgmma M = 64 tiles)
MAX_B_STAGES = 16  # weight ring depth at most (kMaxBStages)
MAX_ROWS = 256  # raw tile rows: the TMA box limit
MAX_SMEM = 232448  # dynamic shared memory a block can have
PAIR_SMEM = 115712  # ... that each of two blocks on one SM can have
# kernel modes (csrc/mrf_section.cu Mode)
MODE_TO_SCRATCH, MODE_OUT_STORE, MODE_OUT_ADD = range(3)


# Copied from larynx_tpu/ops/mrf_block.py::chain_halo.
def chain_halo(
    kernel_size: int,
    dilations: typing.Sequence[int],
    convs_per_unit: int = 2,
) -> int:
    """One chain's receptive-field halo: per unit, (k-1)/2 * d for the
    dilated conv plus (k-1)/2 for the trailing plain conv (ResBlock1
    only; ResBlock2 units have a single dilated conv)."""
    half = (kernel_size - 1) // 2
    plain = half if convs_per_unit == 2 else 0
    return sum(half * d + plain for d in dilations)


def unit_stride(kernel_size: int, convs_per_unit: int = 2) -> int:
    """Output rows per block of a unit launch: the second conv of a
    ResBlock1 unit loses (k-1) of the first conv's TILE_ROWS rows."""
    return TILE_ROWS - (kernel_size - 1) if convs_per_unit == 2 else TILE_ROWS


def unit_rows(kernel_size: int, dilation: int) -> int:
    """Input rows a block loads: the first conv's TILE_ROWS rows and its
    (k-1)/2 * d halo on each side."""
    return TILE_ROWS + (kernel_size - 1) * dilation


def _planes(dtype: torch.dtype) -> int:
    """Operand planes per value: TF32 hi and lo (float32) or one (bfloat16)."""
    return 2 if dtype == torch.float32 else 1


def _kstep(dtype: torch.dtype) -> int:
    """Input channels per wgmma k-step: 32 bytes of the element type."""
    return 32 // dtype.itemsize


def _kchannels(channels: int, dtype: torch.dtype) -> int:
    """Input channels the k-steps span: C, zero-padded to one k-step
    (bfloat16 at C=8: 16)."""
    return max(channels, _kstep(dtype))


def _stage_bytes(channels: int, dtype: torch.dtype) -> int:
    """One weight stage: (tap, one k-step of input channels) x C outputs,
    every plane: 64*C bytes in float32, 32*C in bfloat16."""
    return _planes(dtype) * _kstep(dtype) * channels * dtype.itemsize


def _unit_fixed_bytes(channels: int, rows: int, dtype: torch.dtype = torch.float32) -> int:
    """1 KB of alignment slack, the tile's planes ([CK/g][rows padded to 8]
    [g], 16-byte channel groups; float32: TF32 hi and lo) and the mbarriers."""
    tile = (rows + 7) // 8 * 8 * _kchannels(channels, dtype) * dtype.itemsize
    return 1024 + _planes(dtype) * tile + 8 * (1 + 2 * MAX_B_STAGES)


def unit_b_stages(channels: int, rows: int, dtype: torch.dtype = torch.float32) -> int:
    """The weight ring's depth (csrc ``b_stages``): as many stages
    (:func:`_stage_bytes`) as the shared memory left holds, within half an
    SM at C <= 64 where 4 stages still fit (two blocks per SM), at most
    MAX_B_STAGES."""
    fixed = _unit_fixed_bytes(channels, rows, dtype)
    stage = _stage_bytes(channels, dtype)
    budget = PAIR_SMEM if channels <= 64 and fixed + 4 * stage <= PAIR_SMEM else MAX_SMEM
    return 0 if fixed > budget else min(MAX_B_STAGES, (budget - fixed) // stage)


def unit_smem_bytes(channels: int, rows: int, dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of a unit block (csrc ``smem_bytes``)."""
    return (_unit_fixed_bytes(channels, rows, dtype)
            + unit_b_stages(channels, rows, dtype) * _stage_bytes(channels, dtype))


def pack_mrf_weights(resblocks: typing.Sequence[dict]) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """A stage's resblock params (convs ``[C_out, C_in, k]``) -> (w_flat, b_flat).

    ResBlock1 dicts carry ``convs1``/``convs2``; ResBlock2 dicts ``convs``.
    """
    ws, bs = [], []
    for block in resblocks:
        if "convs1" in block:
            convs = [c for pair in zip(block["convs1"], block["convs2"]) for c in pair]
        else:
            convs = block["convs"]
        for conv in convs:
            ws.append(conv["w"].permute(2, 1, 0).reshape(-1))
            bs.append(conv["b"])
    return torch.cat(ws).contiguous(), torch.stack(bs).contiguous()


def _unpacked_convs(w_flat, b_flat, channels, kernel_sizes, dilations_per_block, convs_per_unit):
    """Yield (chain, unit, [(w [C_out, C_in, k], b, dilation), ...]) from the packing."""
    c = channels
    off = 0
    idx = 0
    for r, (k, dils) in enumerate(zip(kernel_sizes, dilations_per_block)):
        for u, d in enumerate(dils):
            convs = []
            for i in range(convs_per_unit):
                w = w_flat[off : off + k * c * c].view(k, c, c).permute(2, 1, 0)
                convs.append((w, b_flat[idx], d if i == 0 else 1))
                off += k * c * c
                idx += 1
            yield r, u, convs


def _tf32_split(w: torch.Tensor) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """w -> (hi, lo), both exact TF32 values (low 13 mantissa bits zero),
    hi rounded to nearest and lo the rounded remainder: hi + lo = w to
    ~2^-22 relative."""
    hi = ((w.view(torch.int32) + 0x1000) & -8192).view(torch.float32)
    lo = w - hi
    lo = ((lo.view(torch.int32) + 0x1000) & -8192).view(torch.float32)
    return hi, lo


def pack_stages(
    w_flat: torch.Tensor,
    channels: int,
    kernel_sizes: typing.Sequence[int],
    dilations_per_block: typing.Sequence[typing.Sequence[int]],
    convs_per_unit: int,
) -> torch.Tensor:
    """Kernel-order weights -> the kernel's weight stages, flat, in
    ``w_flat``'s dtype.

    float32: per conv, in execution order, one stage per k-step, i.e. per
    (tap, 8 input channels): ``[tap][kstep][plane][ngrp][khalf][r8][k4]``
    with plane 0 the TF32 hi and 1 the lo of ``W[tap][c_in][c_out]`` at
    ``c_in = 8*kstep + 4*khalf + k4``, ``c_out = 8*ngrp + r8``.  Each plane
    is a K-major wgmma B operand without swizzle: core matrices of 8 output
    channels x 16 bytes of inputs (128 bytes), the two input halves
    adjacent, 8-channel groups 256 bytes apart.  Twice the f32 bytes, as the
    hi and lo planes.

    bfloat16: the same with one plane and 16 input channels per k-step:
    ``[tap][kstep][ngrp][khalf][r8][k8]``, ``c_in = 16*kstep + 8*khalf +
    k8``; at C=8 the input channels are zero-padded to 16.
    """
    c = channels
    bf16 = w_flat.dtype == torch.bfloat16
    ck = _kchannels(c, w_flat.dtype)
    parts = []
    off = 0
    for k, dils in zip(kernel_sizes, dilations_per_block):
        n = len(dils) * convs_per_unit
        w = w_flat[off : off + n * k * c * c].view(n, k, c, c)
        off += n * k * c * c
        if bf16:
            w = F.pad(w, (0, 0, 0, ck - c)).reshape(n, k, ck // 16, 2, 8, c // 8, 8)
            # (conv, tap, ks, kh, k8, ngrp, r8) -> (conv, tap, ks, ngrp, kh, r8, k8)
            v = w.permute(0, 1, 2, 5, 3, 6, 4)
        else:
            hi, lo = _tf32_split(w.reshape(n, k, c // 8, 2, 4, c // 8, 8).contiguous())
            # (plane, conv, tap, ks, kh, k4, ngrp, r8) -> (conv, tap, ks, plane, ngrp, kh, r8, k4)
            v = torch.stack([hi, lo]).permute(1, 2, 3, 0, 6, 4, 7, 5)
        parts.append(v.contiguous().reshape(-1))
    return torch.cat(parts)


@dataclasses.dataclass(frozen=True)
class MRFStage:
    """One stage's MRF section, packed for :func:`mrf_section`: the kernel
    order (``w_flat``, ``b_flat``) for the plain version, the weight stages
    (``wpack``, :func:`pack_stages`; None where the kernel does not take C)
    for the kernel, and the resblock geometry; all in the params' dtype."""

    w_flat: torch.Tensor
    b_flat: torch.Tensor
    wpack: typing.Optional[torch.Tensor]
    kernel_sizes: typing.Tuple[int, ...]
    dilations_per_block: typing.Tuple[typing.Tuple[int, ...], ...]
    convs_per_unit: int


def pack_mrf_stage(
    resblocks: typing.Sequence[dict],
    kernel_sizes: typing.Sequence[int] = (3, 7, 11),
    dilations_per_block: typing.Sequence[typing.Sequence[int]] = ((1, 3, 5),) * 3,
    convs_per_unit: int = 2,
) -> MRFStage:
    """A stage's resblock params -> :class:`MRFStage`, on the params' device
    and in their dtype."""
    w_flat, b_flat = pack_mrf_weights(resblocks)
    kernel_sizes = tuple(kernel_sizes)
    dilations_per_block = tuple(tuple(d) for d in dilations_per_block)
    c = b_flat.shape[-1]
    wpack = None
    if c in KERNEL_CHANNELS and w_flat.dtype in KERNEL_DTYPES:
        wpack = pack_stages(w_flat, c, kernel_sizes, dilations_per_block, convs_per_unit)
    return MRFStage(w_flat, b_flat, wpack, kernel_sizes, dilations_per_block, convs_per_unit)


# -----------------------------------------------------------------------------
# Plain versions


def _bf16_values(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to bfloat16 (nearest even), kept as float32."""
    return x.to(torch.bfloat16).float()


def _unit_bf16(h: torch.Tensor, convs) -> torch.Tensor:
    """One resblock unit in bfloat16, on float32 tensors that hold bfloat16
    values: every conv in float32 (exact products, float32 sums) rounded
    once, the leaky-ReLU as JAX's bfloat16 one, h + conv rounded."""
    xt = h.transpose(1, 2)
    for w, b, d in convs:
        k = w.shape[-1]
        xt = torch.where(xt >= 0, xt, _bf16_values(xt * LRELU_SLOPE_BF16))
        xt = _bf16_values(F.conv1d(xt, w.float(), b.float(), padding=(k - 1) // 2 * d,
                                   dilation=d))
    return _bf16_values(h + xt.transpose(1, 2))


def mrf_unit_plain(h: torch.Tensor, convs) -> torch.Tensor:
    """One resblock unit, h [B, T, C] -> h + (lrelu -> conv)* (h), with
    ``convs`` the unit's [(w [C_out, C_in, k], b, dilation), ...] (two for
    ResBlock1, one for ResBlock2).  bfloat16 h rounds where the kernel does
    (the module docstring); not bfloat16 convs, whose rounding differs."""
    if h.dtype == torch.bfloat16:
        return _unit_bf16(h.float(), convs).to(torch.bfloat16)
    xt = h.transpose(1, 2)
    for w, b, d in convs:
        k = w.shape[-1]
        xt = F.leaky_relu(xt, LRELU_SLOPE)
        xt = F.conv1d(xt, w, b, padding=(k - 1) // 2 * d, dilation=d)
    return h + xt.transpose(1, 2)


def mrf_section_plain(
    x: torch.Tensor,
    w_flat: torch.Tensor,
    b_flat: torch.Tensor,
    kernel_sizes: typing.Sequence[int] = (3, 7, 11),
    dilations_per_block: typing.Sequence[typing.Sequence[int]] = ((1, 3, 5),) * 3,
    convs_per_unit: int = 2,
) -> torch.Tensor:
    """x [B, T, C] -> averaged MRF section [B, T, C], one F.conv1d per conv.

    bfloat16 x runs on float32 copies rounded where the kernel rounds, the
    chains' sum in float32 (the module docstring)."""
    c = x.shape[-1]
    if x.dtype == torch.bfloat16:
        h = total = None
        for r, u, convs in _unpacked_convs(
            w_flat, b_flat, c, kernel_sizes, dilations_per_block, convs_per_unit
        ):
            if u == 0:
                if h is not None:
                    total = h if total is None else total + h
                h = x.float()
            h = _unit_bf16(h, convs)
        total = h if total is None else total + h
        return (total / len(kernel_sizes)).to(torch.bfloat16)
    h = None
    total = None
    for r, u, convs in _unpacked_convs(
        w_flat, b_flat, c, kernel_sizes, dilations_per_block, convs_per_unit
    ):
        if u == 0:
            if h is not None:
                total = h if total is None else total + h
            h = x.transpose(1, 2)
        xt = h
        for w, b, d in convs:
            k = w.shape[-1]
            xt = F.leaky_relu(xt, LRELU_SLOPE)
            xt = F.conv1d(xt, w, b, padding=(k - 1) // 2 * d, dilation=d)
        h = h + xt
    total = h if total is None else total + h
    return (total / len(kernel_sizes)).transpose(1, 2)


def _check(x: torch.Tensor, stage: MRFStage) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, C], got shape {tuple(x.shape)}")
    b, t, c = x.shape
    if c not in KERNEL_CHANNELS:
        raise NotImplementedError(f"mrf_section kernel takes C in {KERNEL_CHANNELS}, got {c}")
    if not 1 <= b <= 65535 or t < 1:
        raise ValueError(f"mrf_section kernel takes 1 <= B <= 65535 and T >= 1, got {b}, {t}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"mrf_section kernel takes x, wpack and b_flat all float32 or all "
                        f"bfloat16, got x {x.dtype}")
    kernel_sizes, dilations_per_block = stage.kernel_sizes, stage.dilations_per_block
    convs_per_unit = stage.convs_per_unit
    if convs_per_unit not in (1, 2):
        raise ValueError(f"convs_per_unit must be 1 or 2, got {convs_per_unit}")
    if not kernel_sizes or len(kernel_sizes) != len(dilations_per_block):
        raise ValueError("need resblocks, each with a kernel size and dilations")
    if any(not dils for dils in dilations_per_block):
        raise ValueError("each resblock needs at least one dilation")
    if any(k % 2 == 0 or k >= TILE_ROWS for k in kernel_sizes):
        raise ValueError(f"kernel sizes must be odd and below {TILE_ROWS}, got {kernel_sizes}")
    for k, dils in zip(kernel_sizes, dilations_per_block):
        for d in dils:
            rows = unit_rows(k, d)
            if d < 1 or rows > MAX_ROWS or unit_b_stages(c, rows, x.dtype) < 2:
                raise NotImplementedError(
                    f"mrf_section kernel: unit (k={k}, d={d}) at C={c} needs {rows} input rows, "
                    f"{unit_smem_bytes(c, rows, x.dtype)} bytes of shared memory"
                )
    if stage.wpack is None:
        raise ValueError(f"the stage was packed without the kernel's weights, x has C={c}")
    dtype = x.dtype
    n_convs = convs_per_unit * sum(len(d) for d in dilations_per_block)
    taps = sum(k * len(d) for k, d in zip(kernel_sizes, dilations_per_block))
    n_w = _planes(dtype) * convs_per_unit * _kchannels(c, dtype) * c * taps
    for name, v in (("x", x), ("wpack", stage.wpack), ("b_flat", stage.b_flat)):
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if v.dtype not in KERNEL_DTYPES or v.dtype != dtype:
            raise TypeError(
                "mrf_section kernel takes x, wpack and b_flat all float32 or all bfloat16, "
                f"got x {x.dtype}, {name} {v.dtype}"
            )
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if v.data_ptr() % 16:  # TMA copies start on 16-byte boundaries
            raise ValueError(f"{name} must be 16-byte aligned")
    if stage.wpack.dim() != 1 or stage.wpack.numel() != n_w:
        raise ValueError(
            f"wpack must hold {n_w} values, has shape {tuple(stage.wpack.shape)}"
        )
    if tuple(stage.b_flat.shape) != (n_convs, c):
        raise ValueError(f"b_flat must be ({n_convs}, {c}), got {tuple(stage.b_flat.shape)}")


def _setup(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mrf_unit_f32.restype = i
    lib.mrf_unit_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
    lib.mrf_unit_bf16.restype = i
    lib.mrf_unit_bf16.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, p]
    for suffix in ("", "_bf16"):
        getattr(lib, f"mrf_unit_smem_bytes{suffix}").restype = ctypes.c_longlong
        getattr(lib, f"mrf_unit_smem_bytes{suffix}").argtypes = [i, i]
        getattr(lib, f"mrf_unit_b_stages{suffix}").restype = i
        getattr(lib, f"mrf_unit_b_stages{suffix}").argtypes = [i, i]
    lib.mrf_section_error_string.restype = ctypes.c_char_p
    lib.mrf_section_error_string.argtypes = [i]


def _library() -> ctypes.CDLL:
    from larynx_tpu_torch.ops.build import load_library

    lib = load_library("mrf_section")
    if not hasattr(lib, "_larynx_ready"):
        _setup(lib)
        lib._larynx_ready = True
    return lib


def unit_launches(stage: MRFStage):
    """The section's unit launches in order: (chain, unit, k, d, weight
    offset, bias row, source, destination, mode, scale).  Source and
    destination name a buffer: "x", "out", or scratch 0 / 1; unit u of a
    chain reads x (u = 0) or scratch (u-1) % 2 and writes scratch u % 2,
    except the chain's last unit, which writes out: stored by the first
    chain, added by later ones, scaled by 1/n_chains on the last.  (In
    bfloat16 the chains' sum goes to a float32 buffer, and the last chain
    writes out.)  The weight offset counts elements of ``wpack``."""
    c = stage.b_flat.shape[-1]
    dtype = stage.w_flat.dtype
    unit_values = _planes(dtype) * _kchannels(c, dtype) * c
    cpu = stage.convs_per_unit
    n_chains = len(stage.kernel_sizes)
    w_off = b_row = 0
    plan = []
    for r, (k, dils) in enumerate(zip(stage.kernel_sizes, stage.dilations_per_block)):
        for u, d in enumerate(dils):
            src = "x" if u == 0 else (u - 1) % 2
            if u == len(dils) - 1:
                dst, mode = "out", (MODE_OUT_STORE if r == 0 else MODE_OUT_ADD)
                scale = 1.0 / n_chains if r == n_chains - 1 else 1.0
            else:
                dst, mode, scale = u % 2, MODE_TO_SCRATCH, 1.0
            plan.append((r, u, k, d, w_off, b_row, src, dst, mode, scale))
            w_off += cpu * k * unit_values
            b_row += cpu
    return plan


def mrf_section(x: torch.Tensor, stage: MRFStage) -> torch.Tensor:
    """x [B, T, C] -> averaged MRF section output [B, T, C], float32 or
    bfloat16 as x and the stage are.

    A CPU tensor runs :func:`mrf_section_plain`; a CUDA tensor launches the
    kernel once per resblock unit (:func:`unit_launches`), on the current
    stream, or raises.  Two scratch buffers of x's size carry a chain's
    state between its units; in bfloat16 a float32 buffer holds the chains'
    sum.
    """
    if x.device.type == "cpu":
        return mrf_section_plain(
            x, stage.w_flat, stage.b_flat, stage.kernel_sizes, stage.dilations_per_block,
            stage.convs_per_unit,
        )
    if x.device.type != "cuda":
        raise ValueError(f"mrf_section runs on cpu or cuda tensors, got {x.device}")
    _check(x, stage)
    lib = _library()
    b, t, c = x.shape
    bf16 = x.dtype == torch.bfloat16
    plan = unit_launches(stage)
    n_chains = len(stage.kernel_sizes)
    n_scratch = min(2, max(len(d) for d in stage.dilations_per_block) - 1)
    buffers = {"x": x, "out": torch.empty_like(x)}
    for i in range(n_scratch):
        buffers[i] = torch.empty_like(x)
    if bf16 and n_chains > 1:
        buffers["total"] = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    total = buffers["total"].data_ptr() if "total" in buffers else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    w_base, b_base = stage.wpack.data_ptr(), stage.b_flat.data_ptr()
    size = x.element_size()
    with torch.cuda.device(x.device):
        for r, _u, k, d, w_off, b_row, src, dst, mode, scale in plan:
            args = (buffers[src].data_ptr(), w_base + size * w_off, b_base + size * b_row * c,
                    buffers[dst].data_ptr())
            if bf16:
                err = lib.mrf_unit_bf16(
                    *args, total, b, t, c, stage.convs_per_unit, k, d, mode,
                    int(r == n_chains - 1), scale, stream,
                )
            else:
                err = lib.mrf_unit_f32(
                    *args, b, t, c, stage.convs_per_unit, k, d, mode, scale, stream,
                )
            if err != 0:
                raise RuntimeError(
                    f"mrf_section launch failed: {lib.mrf_section_error_string(err).decode()}"
                )
            mrf_section.launches += 1
    return buffers["out"]


mrf_section.launches = 0  # kernel launches made by mrf_section (one per resblock unit)
