"""Tacotron2's autoregressive decoder steps as one persistent CUDA kernel a
call (``csrc/tacotron2_step.cu``).

The JAX package leaves the step to XLA and has no Pallas kernel for it, so
this kernel replaces none: it is here because a step is bound by the bytes
of its 18.2 M float32 weights, which a step's ~59 small PyTorch launches
stream at a fraction of the HBM rate.  :func:`decode_steps` runs ``n`` steps
of ``models/tacotron2/model.py::decode_steps`` in one launch for a CUDA
tensor; on the CPU the model runs its own step loop.
:func:`decode_steps_plain`, the same arithmetic in plain torch on the same
packed weights, is the kernel's reference.  There is no other route: a
tensor off CUDA raises, and so does a CUDA tensor the kernel does not take
(:func:`check_launch`).

The weights travel packed (:func:`pack_decoder`, once per loaded voice, as
:class:`PackedDecoder`): each LSTM's ``[w_ih | w_hh]`` joined into one
row-major matrix whose four gate rows (torch's i, f, g, o) of hidden unit j
are rows 4j..4j+3 (:func:`interleave_gates`), so a warp of the kernel owns
whole units; the projection and the gate joined, their rows padded to a
multiple of 4 with zeros.  Everything is float32: the products run as
float32 FFMA on CUDA cores, never TF32, whatever ``allow_tf32`` says.
"""

import ctypes
import dataclasses
import typing

import torch
import torch.nn.functional as F

from larynx_tpu_torch.runtime import trace

MAX_ROWS = 8  # batch rows a launch holds in registers; more run in groups
STATE_KEYS = ("attn_h", "attn_c", "dec_h", "dec_c", "attn_w", "attn_w_cum", "context")
_MASK_VALUE = -1e9


@dataclasses.dataclass(frozen=True)
class PackedDecoder:
    """A Tacotron2 decoder's step weights in the kernel's layout: ``pre1``
    [P, M], ``pre2`` [P, P]; ``att_w`` [4 H1, P + E + H1] (columns prenet,
    context, h) and ``att_b`` [4 H1]; ``dec_w`` [4 H2, H1 + E + H2] (columns
    attention h, context, h) and ``dec_b``; the gates interleaved per unit;
    ``proj_w`` [MO, H2 + E] (M mel rows, the gate's row, zero rows up to a
    multiple of 4) and ``proj_b`` [MO]; ``query`` [A, H1]; the location
    layers transposed, so that the kernel's neighbouring threads read
    neighbouring filters and channels: ``conv`` [2, K, F] (torch's [F, 2, K])
    and ``dense`` [F, A]; ``v`` [A].  ``p_dropout`` is the prenet's."""

    pre1: torch.Tensor
    pre2: torch.Tensor
    att_w: torch.Tensor
    att_b: torch.Tensor
    dec_w: torch.Tensor
    dec_b: torch.Tensor
    proj_w: torch.Tensor
    proj_b: torch.Tensor
    query: torch.Tensor
    conv: torch.Tensor
    dense: torch.Tensor
    v: torch.Tensor
    p_dropout: float

    @property
    def mel_channels(self) -> int:
        return self.pre1.shape[1]

    def tensors(self) -> typing.List[torch.Tensor]:
        """The weights in the order the kernel takes them."""
        return [self.pre1, self.pre2, self.att_w, self.att_b, self.dec_w, self.dec_b,
                self.proj_w, self.proj_b, self.query, self.conv, self.dense, self.v]


def interleave_gates(w: torch.Tensor) -> torch.Tensor:
    """[4H, ...] in torch's gate blocks (i, f, g, o) -> row 4j + r = gate r of
    unit j."""
    h = w.shape[0] // 4
    return w.reshape(4, h, *w.shape[1:]).transpose(0, 1).reshape(w.shape).contiguous()


def deinterleave_gates(w: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`interleave_gates`."""
    h = w.shape[0] // 4
    return w.reshape(h, 4, *w.shape[1:]).transpose(0, 1).reshape(w.shape).contiguous()


def pack_decoder(dec, p_dropout: float) -> PackedDecoder:
    """A decoder's params (the port's tree, ``params["decoder"]``) ->
    :class:`PackedDecoder` on their device and in their dtype."""
    att, rnn = dec["attention_rnn"], dec["decoder_rnn"]
    proj_w = torch.cat([dec["projection"]["w"], dec["gate"]["w"]])
    proj_b = torch.cat([dec["projection"]["b"], dec["gate"]["b"]])
    pad = -proj_w.shape[0] % 4
    proj_w = F.pad(proj_w, (0, 0, 0, pad))
    proj_b = F.pad(proj_b, (0, pad))
    attention = dec["attention"]
    return PackedDecoder(
        pre1=dec["prenet"][0]["w"].contiguous(), pre2=dec["prenet"][1]["w"].contiguous(),
        att_w=interleave_gates(torch.cat([att["w_ih"], att["w_hh"]], dim=1)),
        att_b=interleave_gates(att["b"]),
        dec_w=interleave_gates(torch.cat([rnn["w_ih"], rnn["w_hh"]], dim=1)),
        dec_b=interleave_gates(rnn["b"]),
        proj_w=proj_w.contiguous(), proj_b=proj_b.contiguous(),
        query=attention["query"]["w"].contiguous(),
        conv=attention["location_conv"].permute(1, 2, 0).contiguous(),
        dense=attention["location_dense"]["w"].t().contiguous(),
        v=attention["v"]["w"].reshape(-1).contiguous(),
        p_dropout=float(p_dropout))


# -----------------------------------------------------------------------------
# Plain version


def _cell(gates: torch.Tensor, c: torch.Tensor):
    """Interleaved gate sums [B, 4H] -> (h, c)."""
    g = gates.reshape(gates.shape[0], -1, 4)
    i, f, gg, o = (g[..., r] for r in range(4))
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def decode_steps_plain(packed: PackedDecoder, state: dict, prev: torch.Tensor,
                       memory: torch.Tensor, processed_memory: torch.Tensor, mask: torch.Tensor,
                       n: int, keep: typing.Optional[torch.Tensor] = None):
    """``n`` decoder steps in plain torch on the packed weights, in the
    kernel's order of stages -> (state, last frame, mels [B, n, M], gate
    logits [B, n]); ``keep`` [n, 2, B, P] (bool) or None."""
    m = packed.mel_channels
    st = dict(state)
    mels, gates = [], []
    for s in range(n):
        x = prev
        for layer, w in enumerate((packed.pre1, packed.pre2)):
            x = torch.relu(F.linear(x, w))
            if packed.p_dropout > 0.0 and keep is not None:
                x = torch.where(keep[s, layer], x / (1.0 - packed.p_dropout), 0.0)
        attn_h, attn_c = _cell(
            F.linear(torch.cat([x, st["context"], st["attn_h"]], dim=-1), packed.att_w,
                     packed.att_b), st["attn_c"])
        cat = torch.stack([st["attn_w"], st["attn_w_cum"]], dim=1)  # [B, 2, T]
        k = packed.conv.shape[1]
        loc = F.conv1d(cat, packed.conv.permute(2, 0, 1), padding=(k - 1) // 2)
        loc = processed_memory + loc.transpose(1, 2) @ packed.dense  # [B, T, A]
        query = F.linear(attn_h, packed.query)
        energies = torch.tanh(query[:, None, :] + loc) @ packed.v  # [B, T]
        weights = torch.softmax(torch.where(mask > 0, energies, _MASK_VALUE), dim=-1)
        context = torch.bmm(weights[:, None, :], memory).squeeze(1)
        dec_h, dec_c = _cell(
            F.linear(torch.cat([attn_h, context, st["dec_h"]], dim=-1), packed.dec_w,
                     packed.dec_b), st["dec_c"])
        out = F.linear(torch.cat([dec_h, context], dim=-1), packed.proj_w, packed.proj_b)
        prev = out[:, :m]
        mels.append(prev)
        gates.append(out[:, m])
        st = {"attn_h": attn_h, "attn_c": attn_c, "dec_h": dec_h, "dec_c": dec_c,
              "attn_w": weights, "attn_w_cum": st["attn_w_cum"] + weights, "context": context}
    return st, prev, torch.stack(mels, dim=1), torch.stack(gates, dim=1)


# -----------------------------------------------------------------------------
# The kernel


def check_launch(packed: PackedDecoder, state: dict, prev: torch.Tensor, memory: torch.Tensor,
                 processed_memory: torch.Tensor, mask: torch.Tensor, n: int,
                 keep: typing.Optional[torch.Tensor] = None) -> None:
    """Raises for what the kernel does not take: a dtype other than float32
    (keep: bool), tensors on two devices, non-contiguous tensors (the last
    frame may be a row view with unit stride), widths that are not
    multiples of 4, an even location kernel, or shapes that disagree."""
    if memory.dim() != 3:
        raise ValueError(f"memory must be [B, T, E], got {tuple(memory.shape)}")
    b, t, e = memory.shape
    m = packed.mel_channels
    p, h1 = packed.pre1.shape[0], packed.query.shape[1]
    h2 = packed.dec_w.shape[0] // 4
    a, f, k = packed.query.shape[0], packed.conv.shape[2], packed.conv.shape[1]
    widths = {"mel_channels": m, "prenet_dim": p, "encoder_embedding_dim": e,
              "attention_rnn_dim": h1, "decoder_rnn_dim": h2, "attention_dim": a,
              "attention_location_n_filters": f}
    for name, width in widths.items():
        if width % 4:
            raise NotImplementedError(f"the step kernel takes widths that are multiples of 4, "
                                      f"{name} is {width}")
    if k % 2 == 0:
        raise NotImplementedError(f"the step kernel takes an odd location kernel, got {k}")
    if b < 1 or t < 1 or n < 1:
        raise ValueError(f"the step kernel takes B, T, n >= 1, got {b}, {t}, {n}")
    want = {"attn_h": (b, h1), "attn_c": (b, h1), "dec_h": (b, h2), "dec_c": (b, h2),
            "attn_w": (b, t), "attn_w_cum": (b, t), "context": (b, e)}
    if set(state) != set(STATE_KEYS):
        raise ValueError(f"state keys {sorted(state)}, expected {sorted(STATE_KEYS)}")
    shapes = {**{f"state[{key!r}]": (state[key], shape) for key, shape in want.items()},
              "prev": (prev, (b, m)), "processed_memory": (processed_memory, (b, t, a)),
              "mask": (mask, (b, t))}
    if packed.att_w.shape[1] != p + e + h1 or packed.dec_w.shape[1] != h1 + e + h2 \
            or packed.proj_w.shape[1] != h2 + e:
        raise ValueError("the packed weights do not match the memory's width")
    tensors = dict((name, x) for name, (x, _) in shapes.items())
    tensors.update({"memory": memory})
    tensors.update({f"weight {i}": w for i, w in enumerate(packed.tensors())})
    for name, (x, shape) in shapes.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    if keep is not None:
        if keep.dtype != torch.bool or tuple(keep.shape) != (n, 2, b, p):
            raise ValueError(f"keep must be bool [{n}, 2, {b}, {p}], got {keep.dtype} "
                             f"{tuple(keep.shape)}")
        tensors["keep"] = keep
    for name, x in tensors.items():
        if x.device != memory.device:
            raise ValueError(f"{name} is on {x.device}, memory on {memory.device}")
        if name != "keep" and x.dtype != torch.float32:
            raise TypeError(f"the step kernel takes float32, {name} is {x.dtype}")
        if name == "prev":
            if x.stride(1) != 1 or x.stride(0) % 4 or x.data_ptr() % 16:
                raise ValueError("prev's rows must be contiguous and 16-byte aligned")
        elif not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _library() -> ctypes.CDLL:
    from larynx_tpu_torch.ops.build import load_library

    lib = load_library("tacotron2_step")
    if not hasattr(lib, "_larynx_ready"):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tacotron2_steps.restype = i
        lib.tacotron2_steps.argtypes = [p, p, ctypes.c_float, p]
        lib.tacotron2_step_scratch_floats.restype = ctypes.c_longlong
        lib.tacotron2_step_scratch_floats.argtypes = [p]
        lib.tacotron2_step_geometry.restype = i
        lib.tacotron2_step_geometry.argtypes = [p, p]
        lib.tacotron2_step_error_string.restype = ctypes.c_char_p
        lib.tacotron2_step_error_string.argtypes = [i]
        lib._larynx_ready = True
    return lib


def _dims(packed: PackedDecoder, b: int, t: int, n: int, prev_stride: int):
    e = packed.proj_w.shape[1] - packed.dec_w.shape[0] // 4
    return (ctypes.c_int * 12)(
        b, t, n, packed.mel_channels, packed.pre1.shape[0], e, packed.query.shape[1],
        packed.dec_w.shape[0] // 4, packed.query.shape[0], packed.conv.shape[2],
        packed.conv.shape[1], prev_stride)


def geometry(packed: PackedDecoder, b: int, t: int) -> dict:
    """The kernel's launch plan for B rows at text length T on the current
    CUDA device."""
    lib = _library()
    out = (ctypes.c_int * 6)()
    err = lib.tacotron2_step_geometry(_dims(packed, b, t, 1, packed.mel_channels), out)
    if err != 0:
        reason = lib.tacotron2_step_error_string(err).decode()
        raise ValueError(f"tacotron2_step_geometry: {reason}")
    return dict(zip(("grid", "threads", "smem_bytes", "rows_template", "attn_parts",
                     "blocks_per_sm"), list(out)))


def _launch(lib, packed, state, prev, memory, processed_memory, mask, n, keep, out_state,
            mels, gates):
    b, t, _ = memory.shape
    dims = _dims(packed, b, t, n, prev.stride(0))
    scratch = torch.empty((int(lib.tacotron2_step_scratch_floats(dims)),), dtype=torch.float32,
                          device=memory.device)
    tensors = [*packed.tensors(), memory, processed_memory, mask, keep,
               *(state[k] for k in STATE_KEYS[:4]), state["attn_w"], state["attn_w_cum"],
               state["context"], prev, *(out_state[k] for k in STATE_KEYS[:4]),
               out_state["attn_w"], out_state["attn_w_cum"], out_state["context"], mels, gates,
               scratch]
    ptrs = (ctypes.c_void_p * len(tensors))(*[None if x is None else x.data_ptr()
                                              for x in tensors])
    stream = torch.cuda.current_stream(memory.device).cuda_stream
    with torch.cuda.device(memory.device):
        err = lib.tacotron2_steps(ptrs, dims, ctypes.c_float(1.0 - packed.p_dropout), stream)
    if err != 0:
        raise RuntimeError(f"tacotron2_step launch failed: "
                           f"{lib.tacotron2_step_error_string(err).decode()}")
    decode_steps.launches += 1


def decode_steps(packed: PackedDecoder, state: dict, prev: torch.Tensor, memory: torch.Tensor,
                 processed_memory: torch.Tensor, mask: torch.Tensor, n: int,
                 keep: typing.Optional[torch.Tensor] = None):
    """``n`` decoder steps -> (state, last frame, mels [B, n, M], gate logits
    [B, n]), as ``models/tacotron2/model.py::decode_steps``; ``keep``
    [n, 2, B, P] (bool) or None.

    A CUDA tensor launches the kernel once per group of at most
    :data:`MAX_ROWS` rows, or raises, and adds ``n`` to the trace counter
    ``engine.ar_kernel_steps``; any other tensor raises.  The returned state
    is new tensors (the input's are only read) and the last frame a view of
    ``mels``."""
    if memory.device.type != "cuda":
        raise ValueError(f"decode_steps runs on cuda tensors, got {memory.device}")
    if packed.p_dropout <= 0.0:
        keep = None
    check_launch(packed, state, prev, memory, processed_memory, mask, n, keep)
    lib = _library()
    b = memory.shape[0]
    out_state = {k: torch.empty_like(state[k]) for k in STATE_KEYS}
    mels = torch.empty((b, n, packed.mel_channels), dtype=torch.float32, device=memory.device)
    gates = torch.empty((b, n), dtype=torch.float32, device=memory.device)
    for r0 in range(0, b, MAX_ROWS):
        rows = slice(r0, min(r0 + MAX_ROWS, b))
        group_keep = None if keep is None else keep[:, :, rows]
        if group_keep is not None and rows != slice(0, b):
            group_keep = group_keep.contiguous()
        _launch(lib, packed, {k: v[rows] for k, v in state.items()}, prev[rows], memory[rows],
                processed_memory[rows], mask[rows], n, group_keep,
                {k: v[rows] for k, v in out_state.items()}, mels[rows], gates[rows])
    trace.count("engine.ar_kernel_steps", n)
    return out_state, mels[:, -1], mels, gates


decode_steps.launches = 0  # kernel launches made by decode_steps
