"""Fused multi-receptive-field (MRF) section of a HiFi-GAN stage.

Counterpart of ``larynx_tpu/ops/mrf_block.py::fused_mrf`` (both its dense
and its time-packed Pallas kernels).  ``mrf_section`` launches a CUDA kernel
for a CUDA tensor and runs ``mrf_section_plain``, the same function in plain
torch, for a CPU tensor.  There is no other route: a CUDA tensor the kernel
cannot take raises.

Weights travel packed (:func:`pack_mrf_weights`): every conv of the section
in execution order (chain r, unit u, dilated conv then, for ResBlock1, the
plain conv), taps ``[k][C_in][C_out]``, flattened into one buffer of the
params' dtype, with the biases as ``[n_convs, C]``.  The kernels read the
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

The plans, and the kernels' geometry, mirrored here so the CPU tests reach
them:

* float32 (``csrc/mrf_section.cu``): one launch per resblock unit
  (:func:`unit_launches`).  A block's first conv computes ``TILE_ROWS``
  rows, so a ResBlock1 unit's block yields ``TILE_ROWS - (k - 1)`` output
  rows (:func:`unit_stride`) from a raw input tile of ``TILE_ROWS + (k - 1)
  * d`` rows (:func:`unit_rows`).
* bfloat16 (``csrc/mrf_bf16.cu``), chosen by C (:func:`bf16_plan`): at C <=
  64 the whole section in one launch, each block ``R`` output rows of every
  chain with the section's halo ``S`` on each side, intermediates in shared
  memory; at C = 128 one launch per unit as in float32, a block's first conv
  ``BF16_TILE_ROWS`` rows (:func:`bf16_tile`).
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
# kernel modes of a unit launch (csrc Mode)
MODE_TO_SCRATCH, MODE_OUT_STORE, MODE_OUT_ADD = range(3)
# csrc/mrf_bf16.cu geometry
BF16_TILE_ROWS = 256  # kTileRows: a section tile's output rows at most; a unit block's first-conv rows
BF16_SECTION_C = 64  # kSectionC: the section plan's widest C
BF16_MAX_CHAINS = 4  # kMaxChains
BF16_MAX_UNITS = 4  # kMaxUnits


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


def _unit_fixed_bytes(channels: int, rows: int) -> int:
    """1 KB of alignment slack, the tile's TF32 hi and lo planes ([C/4][rows
    padded to 8][4], 16-byte channel groups) and the mbarriers."""
    return 1024 + 2 * ((rows + 7) // 8 * 8 * channels * 4) + 8 * (1 + 2 * MAX_B_STAGES)


def unit_b_stages(channels: int, rows: int) -> int:
    """The float32 weight ring's depth (csrc ``b_stages``): as many stages
    (:func:`_stage_bytes`) as the shared memory left holds, within half an
    SM at C <= 64 where 4 stages still fit (two blocks per SM), at most
    MAX_B_STAGES."""
    fixed = _unit_fixed_bytes(channels, rows)
    stage = _stage_bytes(channels, torch.float32)
    budget = PAIR_SMEM if channels <= 64 and fixed + 4 * stage <= PAIR_SMEM else MAX_SMEM
    return 0 if fixed > budget else min(MAX_B_STAGES, (budget - fixed) // stage)


def unit_smem_bytes(channels: int, rows: int) -> int:
    """Dynamic shared memory of a float32 unit block (csrc ``smem_bytes``)."""
    return (_unit_fixed_bytes(channels, rows)
            + unit_b_stages(channels, rows) * _stage_bytes(channels, torch.float32))


def bf16_plan(channels: int) -> str:
    """The bfloat16 kernel's plan at C: "section" (C <= 64, one launch per
    section) or "units" (C = 128, one launch per resblock unit)."""
    return "section" if channels <= BF16_SECTION_C else "units"


def bf16_tile(
    channels: int,
    kernel_sizes: typing.Sequence[int],
    dilations_per_block: typing.Sequence[typing.Sequence[int]],
    convs_per_unit: int = 2,
) -> typing.Tuple[int, int, int]:
    """(R, S, P) of a bfloat16 launch (csrc ``tile_of``): R output rows per
    block, S halo rows on each side (the largest chain halo), P buffer rows
    (R + 2 S padded to 16: two TMA boxes of P/2).  Section plan: the most
    64-row multiples, at most 256, for which R + 2 S fits the two consumers'
    six 64-row blocks: R = 256 where S <= 64.  Unit plan (one chain of one
    unit): 256 first-conv rows, so R = 256 - (k - 1) for ResBlock1."""
    s = max(chain_halo(k, d, convs_per_unit) for k, d in zip(kernel_sizes, dilations_per_block))
    if bf16_plan(channels) == "section":
        r = min(BF16_TILE_ROWS, (6 * 64 - 2 * s) // 64 * 64)
    else:
        r = BF16_TILE_ROWS - (kernel_sizes[0] - 1 if convs_per_unit == 2 else 0)
    return r, s, (r + 2 * s + 15) // 16 * 16


def _bf16_stage_bytes(channels: int) -> int:
    """A bfloat16 weight stage (csrc ``Geo::kStage``): k-steps of 32*C bytes,
    up to a tap's, at most 8 KB."""
    ksteps = max(channels, 16) // 16
    return min(ksteps, 256 // channels) * 32 * channels


def _bf16_fixed_bytes(channels: int, r: int, p: int) -> int:
    """1 KB of alignment slack; the header (the mbarriers, 128 bytes for the
    launch's chains, its biases: room for 2 * BF16_MAX_CHAINS *
    BF16_MAX_UNITS convs in a section, 2 in a unit; padded to 128 bytes);
    H (C/8 planes) and A (C/8, at C=8 two) buffers of P rows x 16 bytes; the
    section plan's float32 chain sum (R x C)."""
    section = bf16_plan(channels) == "section"
    convs = 2 * BF16_MAX_CHAINS * BF16_MAX_UNITS if section else 2
    header = (8 * (2 + 2 * MAX_B_STAGES) + 128 + convs * channels * 2 + 127) // 128 * 128
    planes = channels // 8 + max(channels, 16) // 8
    total = r * channels * 4 if section else 0
    return 1024 + header + planes * p * 16 + total


def bf16_ring_stages(channels: int, r: int, p: int) -> int:
    """The bfloat16 weight ring's depth (csrc ``ring_stages``): as many
    stages as the shared memory left holds, within half an SM at C <= 32
    where 4 stages still fit, at most MAX_B_STAGES."""
    fixed = _bf16_fixed_bytes(channels, r, p)
    stage = _bf16_stage_bytes(channels)
    pair = channels <= 32 and fixed + 4 * stage <= PAIR_SMEM
    budget = PAIR_SMEM if pair else MAX_SMEM
    return 0 if fixed > budget else min(MAX_B_STAGES, (budget - fixed) // stage)


def bf16_smem_bytes(channels: int, r: int, p: int) -> int:
    """Dynamic shared memory of a bfloat16 block (csrc ``smem_bytes``)."""
    return (_bf16_fixed_bytes(channels, r, p)
            + bf16_ring_stages(channels, r, p) * _bf16_stage_bytes(channels))


def bf16_fits(channels: int, r: int, p: int) -> bool:
    """Whether the bfloat16 kernel takes the tile (csrc ``fits``): at least
    one 64-row block of output, two TMA boxes of at most 256 rows, a weight
    ring of two stages or more."""
    return r >= 64 and p // 2 <= MAX_ROWS and bf16_ring_stages(channels, r, p) >= 2


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
    if any(d < 1 for dils in dilations_per_block for d in dils):
        raise ValueError(f"dilations must be positive, got {dilations_per_block}")
    if any(k % 2 == 0 or k >= TILE_ROWS for k in kernel_sizes):
        raise ValueError(f"kernel sizes must be odd and below {TILE_ROWS}, got {kernel_sizes}")
    if x.dtype == torch.bfloat16 and bf16_plan(c) == "section":
        if (len(kernel_sizes) > BF16_MAX_CHAINS
                or max(len(d) for d in dilations_per_block) > BF16_MAX_UNITS):
            raise NotImplementedError(
                f"mrf_section bf16 kernel takes at most {BF16_MAX_CHAINS} resblocks of "
                f"{BF16_MAX_UNITS} units, got dilations {dilations_per_block}")
        r, s, p = bf16_tile(c, kernel_sizes, dilations_per_block, convs_per_unit)
        if not bf16_fits(c, r, p):
            raise NotImplementedError(
                f"mrf_section bf16 kernel at C={c}: a section halo of {s} rows leaves {r} output "
                f"rows a block, {p} buffer rows, {bf16_smem_bytes(c, r, p)} bytes of shared memory")
    for k, dils in zip(kernel_sizes, dilations_per_block):
        for d in dils:
            if x.dtype == torch.float32:
                rows = unit_rows(k, d)
                fits = rows <= MAX_ROWS and unit_b_stages(c, rows) >= 2
                smem = unit_smem_bytes(c, rows)
            elif bf16_plan(c) == "units":
                r, _s, rows = bf16_tile(c, (k,), ((d,),), convs_per_unit)
                fits = bf16_fits(c, r, rows)
                smem = bf16_smem_bytes(c, r, rows)
            else:
                continue
            if not fits:
                raise NotImplementedError(
                    f"mrf_section kernel: unit (k={k}, d={d}) at C={c} needs {rows} input rows, "
                    f"{smem} bytes of shared memory"
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


def _setup(name: str, lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "mrf_section":
        lib.mrf_unit_f32.restype = i
        lib.mrf_unit_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
        lib.mrf_unit_smem_bytes.restype = ctypes.c_longlong
        lib.mrf_unit_smem_bytes.argtypes = [i, i]
        lib.mrf_unit_b_stages.restype = i
        lib.mrf_unit_b_stages.argtypes = [i, i]
    else:
        lib.mrf_section_bf16.restype = i
        lib.mrf_section_bf16.argtypes = [p, p, p, p, i, i, i, i, i, p, p, p, p]
        lib.mrf_unit_bf16.restype = i
        lib.mrf_unit_bf16.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        lib.mrf_bf16_geometry.restype = i
        lib.mrf_bf16_geometry.argtypes = [i, i, i, p, p, p, p]
    err = getattr(lib, f"{name}_error_string")
    err.restype = ctypes.c_char_p
    err.argtypes = [i]


def _library(dtype: torch.dtype = torch.float32) -> ctypes.CDLL:
    """The float32 kernel's library (``mrf_section``) or the bfloat16
    kernel's (``mrf_bf16``), built at first use."""
    from larynx_tpu_torch.ops.build import load_library

    name = "mrf_bf16" if dtype == torch.bfloat16 else "mrf_section"
    lib = load_library(name)
    if not hasattr(lib, "_larynx_ready"):
        _setup(name, lib)
        lib._larynx_ready = True
    return lib


def _int_arrays(stage: MRFStage):
    """The chains as csrc ``make_chains`` takes them: (kernel sizes, units,
    dilations [n][BF16_MAX_UNITS]) as ctypes int arrays."""
    n = len(stage.kernel_sizes)
    dils = [0] * (n * BF16_MAX_UNITS)
    for r, d in enumerate(stage.dilations_per_block):
        dils[r * BF16_MAX_UNITS : r * BF16_MAX_UNITS + len(d)] = d
    return ((ctypes.c_int * n)(*stage.kernel_sizes),
            (ctypes.c_int * n)(*(len(d) for d in stage.dilations_per_block)),
            (ctypes.c_int * len(dils))(*dils))


def bf16_geometry(stage: MRFStage, channels: int) -> typing.List[int]:
    """The bfloat16 kernel's own geometry for the stage's section (C <= 64)
    or its first unit (C = 128): [R, S, P, ring depth, dynamic shared
    memory, whether it takes it], to hold the mirrors against."""
    lib = _library(torch.bfloat16)
    if bf16_plan(channels) == "units":
        k, d = stage.kernel_sizes[0], stage.dilations_per_block[0][0]
        stage = dataclasses.replace(stage, kernel_sizes=(k,), dilations_per_block=((d,),))
    out = (ctypes.c_longlong * 6)()
    err = lib.mrf_bf16_geometry(channels, stage.convs_per_unit, len(stage.kernel_sizes),
                                *_int_arrays(stage), out)
    if err != 0:
        raise ValueError(f"mrf_bf16_geometry: {lib.mrf_bf16_error_string(err).decode()}")
    return list(out)


def unit_launches(stage: MRFStage):
    """The per-unit plan's launches in order (float32, and bfloat16 at C =
    128): (chain, unit, k, d, weight offset, bias row, source, destination,
    mode, scale).  Source and destination name a buffer: "x", "out", or
    scratch 0 / 1; unit u of a chain reads x (u = 0) or scratch (u-1) % 2
    and writes scratch u % 2, except the chain's last unit, which writes
    out: stored by the first chain, added by later ones, scaled by
    1/n_chains on the last.  (In bfloat16 the chains' sum goes to a float32
    buffer, and the last chain writes out.)  The weight offset counts
    elements of ``wpack``."""
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


def _raise_on(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"mrf_section launch failed: {msg}")


def mrf_section(x: torch.Tensor, stage: MRFStage) -> torch.Tensor:
    """x [B, T, C] -> averaged MRF section output [B, T, C], float32 or
    bfloat16 as x and the stage are.

    A CPU tensor runs :func:`mrf_section_plain`; a CUDA tensor launches a
    kernel on the current stream, or raises: in bfloat16 at C <= 64 once
    for the whole section (``csrc/mrf_bf16.cu``); otherwise once per
    resblock unit (:func:`unit_launches`; ``csrc/mrf_section.cu`` in
    float32, ``csrc/mrf_bf16.cu`` in bfloat16), where two scratch buffers of
    x's size carry a chain's state between its units and, in bfloat16, a
    float32 buffer holds the chains' sum.
    """
    if x.device.type == "cpu":
        return mrf_section_plain(
            x, stage.w_flat, stage.b_flat, stage.kernel_sizes, stage.dilations_per_block,
            stage.convs_per_unit,
        )
    if x.device.type != "cuda":
        raise ValueError(f"mrf_section runs on cpu or cuda tensors, got {x.device}")
    _check(x, stage)
    b, t, c = x.shape
    bf16 = x.dtype == torch.bfloat16
    lib = _library(x.dtype)
    name = "mrf_bf16" if bf16 else "mrf_section"
    stream = torch.cuda.current_stream(x.device).cuda_stream
    w_base, b_base = stage.wpack.data_ptr(), stage.b_flat.data_ptr()
    out = torch.empty_like(x)
    if bf16 and bf16_plan(c) == "section":
        with torch.cuda.device(x.device):
            err = lib.mrf_section_bf16(x.data_ptr(), w_base, b_base, out.data_ptr(), b, t, c,
                                       stage.convs_per_unit, len(stage.kernel_sizes),
                                       *_int_arrays(stage), stream)
            _raise_on(lib, name, err)
            mrf_section.launches += 1
        return out
    plan = unit_launches(stage)
    n_chains = len(stage.kernel_sizes)
    n_scratch = min(2, max(len(d) for d in stage.dilations_per_block) - 1)
    buffers = {"x": x, "out": out}
    for i in range(n_scratch):
        buffers[i] = torch.empty_like(x)
    if bf16 and n_chains > 1:
        buffers["total"] = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    total = buffers["total"].data_ptr() if "total" in buffers else None
    size = x.element_size()
    with torch.cuda.device(x.device):
        for r, _u, k, d, w_off, b_row, src, dst, mode, scale in plan:
            args = (buffers[src].data_ptr(), w_base + size * w_off, b_base + size * b_row * c,
                    buffers[dst].data_ptr())
            if bf16:
                err = lib.mrf_unit_bf16(
                    *args, total, b, t, c, stage.convs_per_unit, k, d, mode,
                    int(r == n_chains - 1), n_chains, stream,
                )
            else:
                err = lib.mrf_unit_f32(
                    *args, b, t, c, stage.convs_per_unit, k, d, mode, scale, stream,
                )
            _raise_on(lib, name, err)
            mrf_section.launches += 1
    return out


mrf_section.launches = 0  # kernel launches made by mrf_section (one per section or unit)
