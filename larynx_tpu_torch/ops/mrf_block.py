"""Fused multi-receptive-field (MRF) section of a HiFi-GAN stage.

Counterpart of ``larynx_tpu/ops/mrf_block.py::fused_mrf`` (both its dense
and its time-packed Pallas kernels).  ``mrf_section`` launches the CUDA
kernel ``csrc/mrf_section.cu`` for a CUDA tensor and runs
``mrf_section_plain``, the same function in plain torch, for a CPU tensor.
There is no other route: a CUDA tensor the kernel cannot take raises.

Weights travel packed (:func:`pack_mrf_weights`): every conv of the section
in execution order (chain r, unit u, dilated conv then, for ResBlock1, the
plain conv), taps ``[k][C_in][C_out]``, flattened into one f32 buffer, with
the biases as ``[n_convs, C]``.  The kernel reads the weights split into
TF32 hi/lo halves in tensor-core fragment order (:func:`pack_fragments`).
:func:`pack_mrf_stage` builds both layouts once, when the weights are
loaded, into the :class:`MRFStage` that ``mrf_section`` takes.
"""

import ctypes
import dataclasses
import typing

import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.1
KERNEL_CHANNELS = (8, 16, 32, 64, 128)
MAX_CHAINS = 4
MAX_UNITS = 4  # kMaxUnits in csrc/mrf_section.cu


def chain_halo(kernel_size: int, dilations: typing.Sequence[int], convs_per_unit: int = 2) -> int:
    """One chain's receptive-field halo: per unit, (k-1)/2 * d for the
    dilated conv plus (k-1)/2 for the trailing plain conv (ResBlock1)."""
    half = (kernel_size - 1) // 2
    plain = half if convs_per_unit == 2 else 0
    return sum(half * d + plain for d in dilations)


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


def pack_fragments(
    w_flat: torch.Tensor,
    channels: int,
    kernel_sizes: typing.Sequence[int],
    dilations_per_block: typing.Sequence[typing.Sequence[int]],
    convs_per_unit: int,
) -> torch.Tensor:
    """Kernel-order weights -> the kernel's mma.m16n8k8 B-fragment order.

    Per conv: ``[tap][k-chunk][n-chunk][lane][b0_hi, b1_hi, b0_lo, b1_lo]``
    with lane = 4*g + t, ``b0 = W[tap][8*kc + t][8*nc + g]`` and
    ``b1 = W[tap][8*kc + t + 4][8*nc + g]`` (W is [k][C_in][C_out]).
    """
    c = channels
    parts = []
    off = 0
    for k, dils in zip(kernel_sizes, dilations_per_block):
        n = len(dils) * convs_per_unit
        w = w_flat[off : off + n * k * c * c].view(n, k, c // 8, 8, c // 8, 8)
        off += n * k * c * c
        # (conv, tap, kc, t, nc, g, pair) -> (conv, tap, kc, nc, g, t, pair)
        b = torch.stack([w[:, :, :, 0:4], w[:, :, :, 4:8]], dim=-1)
        hi, lo = _tf32_split(b.permute(0, 1, 2, 4, 5, 3, 6).contiguous())
        parts.append(torch.cat([hi, lo], dim=-1).reshape(-1))
    return torch.cat(parts)


@dataclasses.dataclass(frozen=True)
class MRFStage:
    """One stage's MRF section, packed for :func:`mrf_section`: the kernel
    order (``w_flat``, ``b_flat``) for the plain version, the fragment order
    (``frags``; None where the kernel does not take C) for the kernel, and
    the resblock geometry."""

    w_flat: torch.Tensor
    b_flat: torch.Tensor
    frags: typing.Optional[torch.Tensor]
    kernel_sizes: typing.Tuple[int, ...]
    dilations_per_block: typing.Tuple[typing.Tuple[int, ...], ...]
    convs_per_unit: int


def pack_mrf_stage(
    resblocks: typing.Sequence[dict],
    kernel_sizes: typing.Sequence[int] = (3, 7, 11),
    dilations_per_block: typing.Sequence[typing.Sequence[int]] = ((1, 3, 5),) * 3,
    convs_per_unit: int = 2,
) -> MRFStage:
    """A stage's resblock params -> :class:`MRFStage`, on the params' device."""
    w_flat, b_flat = pack_mrf_weights(resblocks)
    kernel_sizes = tuple(kernel_sizes)
    dilations_per_block = tuple(tuple(d) for d in dilations_per_block)
    c = b_flat.shape[-1]
    frags = None
    if c in KERNEL_CHANNELS:
        frags = pack_fragments(w_flat, c, kernel_sizes, dilations_per_block, convs_per_unit)
    return MRFStage(w_flat, b_flat, frags, kernel_sizes, dilations_per_block, convs_per_unit)


def mrf_section_plain(
    x: torch.Tensor,
    w_flat: torch.Tensor,
    b_flat: torch.Tensor,
    kernel_sizes: typing.Sequence[int] = (3, 7, 11),
    dilations_per_block: typing.Sequence[typing.Sequence[int]] = ((1, 3, 5),) * 3,
    convs_per_unit: int = 2,
) -> torch.Tensor:
    """x [B, T, C] -> averaged MRF section [B, T, C], one F.conv1d per conv."""
    c = x.shape[-1]
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
    c = x.shape[-1]
    if c not in KERNEL_CHANNELS:
        raise NotImplementedError(f"mrf_section kernel takes C in {KERNEL_CHANNELS}, got {c}")
    kernel_sizes, dilations_per_block = stage.kernel_sizes, stage.dilations_per_block
    convs_per_unit = stage.convs_per_unit
    if convs_per_unit not in (1, 2):
        raise ValueError(f"convs_per_unit must be 1 or 2, got {convs_per_unit}")
    if not 1 <= len(kernel_sizes) <= MAX_CHAINS or len(kernel_sizes) != len(dilations_per_block):
        raise ValueError("need 1..4 resblocks, each with a kernel size and dilations")
    if any(not 1 <= len(d) <= MAX_UNITS for d in dilations_per_block):
        raise ValueError("each resblock needs 1..4 dilations")
    if any(k % 2 == 0 for k in kernel_sizes):
        raise ValueError(f"kernel sizes must be odd, got {kernel_sizes}")
    if stage.frags is None:
        raise ValueError(f"the stage was packed without kernel fragments, x has C={c}")
    n_convs = convs_per_unit * sum(len(d) for d in dilations_per_block)
    n_w =convs_per_unit * c * c * sum(k * len(d) for k, d in zip(kernel_sizes, dilations_per_block))
    for name, t in (("x", x), ("frags", stage.frags), ("b_flat", stage.b_flat)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"mrf_section kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if stage.frags.dim() != 1 or stage.frags.numel() != 2 * n_w:
        raise ValueError(
            f"frags must hold {2 * n_w} values, has shape {tuple(stage.frags.shape)}"
        )
    if tuple(stage.b_flat.shape) != (n_convs, c):
        raise ValueError(f"b_flat must be ({n_convs}, {c}), got {tuple(stage.b_flat.shape)}")


def _setup(lib: ctypes.CDLL) -> None:
    lib.mrf_section_f32.restype = ctypes.c_int
    lib.mrf_section_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.mrf_section_smem_bytes.restype = ctypes.c_longlong
    lib.mrf_section_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.mrf_section_error_string.restype = ctypes.c_char_p
    lib.mrf_section_error_string.argtypes = [ctypes.c_int]


def _library() -> ctypes.CDLL:
    from larynx_tpu_torch.ops.build import load_library

    lib = load_library("mrf_section")
    if not hasattr(lib, "_larynx_ready"):
        _setup(lib)
        lib._larynx_ready = True
    return lib


def _tile(lib: ctypes.CDLL, channels: int, halo: int, props) -> int:
    """The longest time tile (a multiple of 32) whose two haloed buffers fit
    in one block's shared memory: less halo recomputed per output."""
    rows = props.shared_memory_per_block_optin // lib.mrf_section_smem_bytes(channels, 0, 1)
    tile = (rows - 2 * halo) // 32 * 32
    if tile < 32:
        raise ValueError(f"halo {halo} at C={channels} leaves no room for a tile")
    return tile


def mrf_section(x: torch.Tensor, stage: MRFStage) -> torch.Tensor:
    """x [B, T, C] -> averaged MRF section output [B, T, C].

    A CPU tensor runs :func:`mrf_section_plain`; a CUDA tensor launches the
    kernel (one launch for the whole section) or raises.
    """
    kernel_sizes, dilations_per_block = stage.kernel_sizes, stage.dilations_per_block
    convs_per_unit = stage.convs_per_unit
    if x.device.type == "cpu":
        return mrf_section_plain(
            x, stage.w_flat, stage.b_flat, kernel_sizes, dilations_per_block, convs_per_unit
        )
    if x.device.type != "cuda":
        raise ValueError(f"mrf_section runs on cpu or cuda tensors, got {x.device}")
    _check(x, stage)

    lib = _library()
    b, t, c = x.shape
    halo = max(
        chain_halo(k, d, convs_per_unit) for k, d in zip(kernel_sizes, dilations_per_block)
    )
    tile = _tile(lib, c, halo, torch.cuda.get_device_properties(x.device))

    n_chains = len(kernel_sizes)
    ksize = (ctypes.c_int * n_chains)(*kernel_sizes)
    n_units = (ctypes.c_int * n_chains)(*(len(d) for d in dilations_per_block))
    dil = (ctypes.c_int * (n_chains * MAX_UNITS))()
    for r, dils in enumerate(dilations_per_block):
        for u, d in enumerate(dils):
            dil[r * MAX_UNITS + u] = d

    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.mrf_section_f32(
            x.data_ptr(), stage.frags.data_ptr(), stage.b_flat.data_ptr(), out.data_ptr(),
            b, t, c, convs_per_unit, n_chains, ksize, n_units, dil, halo, tile, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"mrf_section launch failed: {lib.mrf_section_error_string(err).decode()}"
        )
    mrf_section.launches += 1
    return out


mrf_section.launches = 0  # kernel launches made by mrf_section
