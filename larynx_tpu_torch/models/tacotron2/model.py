"""Tacotron2 inference, as in ``larynx_tpu/models/tacotron2/model.py``.

Plain functions on the port's parameter tree (``weights.params_from_jax``):
linears and LSTM gates ``[out, in]``, convs ``[C_out, C_in, k]``; the
activations keep the JAX package's channels-last layout.  The JAX package
leaves every product here to XLA (no Pallas kernel), so the port runs them
as PyTorch ops.

  ``encode``            ids [B, T] -> (memory [B, T, E], mask [B, T]):
                        embedding, conv + BatchNorm + ReLU layers, a BiLSTM
                        whose padded steps carry the state unchanged.
  ``decode_inference``  every one of ``max_steps`` autoregressive steps
                        (prenet, attention LSTM, location-sensitive
                        attention, decoder LSTM, projection and gate), with
                        no host sync inside the loop: the stop token flips a
                        ``finished`` mask and the lengths come back as a
                        tensor, as the JAX scan's do.
  ``postnet``           the 5-conv residual refiner.

The NVIDIA quirk of prenet dropout at inference is kept.  The JAX package
draws its masks per step from ``fold_in`` keys, whose bits torch cannot
reproduce; the port takes the whole decode's keep masks as one tensor
(:func:`draw_keep_masks`, or injected by a caller), so the decode has no
per-step random launch and the CUDA and CPU runs use the same masks.
"""

import typing

import numpy as np
import torch
import torch.nn.functional as F

from larynx_tpu_torch.models.nn import conv1d, sequence_mask
from larynx_tpu_torch.models.tacotron2.config import Tacotron2Config

Params = typing.Dict[str, typing.Any]

_MASK_VALUE = -1e9


# -----------------------------------------------------------------------------
# Primitives


def _gates_to_state(gates: torch.Tensor, c: torch.Tensor):
    """Gate pre-activations [B, 4H] (torch order i, f, g, o) -> (h, c)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def lstm_cell(p: Params, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """Fused LSTM cell: ``w_ih`` [4H, in], ``w_hh`` [4H, H], one bias ``b``."""
    return _gates_to_state(F.linear(x, p["w_ih"], p["b"]) + F.linear(h, p["w_hh"]), c)


def _lstm_scan(
    p: Params,
    x: torch.Tensor,
    reverse: bool = False,
    mask: typing.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """An LSTM over time: x [B, T, C] -> h sequence [B, T, H].

    The input projection is one product over all T.  With ``mask`` [B, T]
    a padded step leaves h and c as they were, so the reverse direction
    starts at each row's last valid frame (torch's packed sequences)."""
    bsz, t, _ = x.shape
    hidden = p["w_hh"].shape[1]
    xw = F.linear(x, p["w_ih"], p["b"])  # [B, T, 4H]
    h = x.new_zeros((bsz, hidden))
    c = x.new_zeros((bsz, hidden))
    keep = None if mask is None else (mask > 0)[..., None]  # [B, T, 1]
    hs = []
    for step in (range(t - 1, -1, -1) if reverse else range(t)):
        h_new, c_new = _gates_to_state(xw[:, step] + F.linear(h, p["w_hh"]), c)
        if keep is None:
            h, c = h_new, c_new
        else:
            h = torch.where(keep[:, step], h_new, h)
            c = torch.where(keep[:, step], c_new, c)
        hs.append(h)
    if reverse:
        hs.reverse()
    return torch.stack(hs, dim=1)


def _bn(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm over the channel axis with the running statistics."""
    return (x - p["mean"]) * torch.rsqrt(p["var"] + eps) * p["gamma"] + p["beta"]


# -----------------------------------------------------------------------------
# Encoder


def encode(
    params: Params,
    cfg: Tacotron2Config,
    ids: torch.Tensor,
    lengths: typing.Optional[torch.Tensor] = None,
):
    """ids [B, T] -> (memory [B, T, E], mask [B, T] float {0, 1}).

    Padded positions are zeroed between stages and excluded from attention
    by the mask, so a padded row matches the same row run alone."""
    bsz, t = ids.shape
    if lengths is None:
        lengths = torch.full((bsz,), t, dtype=torch.int32, device=ids.device)
    mask = sequence_mask(lengths, t)
    mask1 = mask[..., None]

    x = params["embedding"][ids]  # [B, T, E]
    for conv in params["encoder"]["convs"]:
        x = torch.relu(_bn(conv["bn"], conv1d(x * mask1, conv["w"], conv["b"])))
    x = x * mask1
    fw = _lstm_scan(params["encoder"]["lstm_fw"], x, mask=mask)
    bw = _lstm_scan(params["encoder"]["lstm_bw"], x, reverse=True, mask=mask)
    return torch.cat([fw, bw], dim=-1) * mask1, mask


# -----------------------------------------------------------------------------
# Decoder


def draw_keep_masks(cfg: Tacotron2Config, max_steps: int, bsz: int, seed: int) -> torch.Tensor:
    """The whole decode's prenet keep masks, [max_steps, 2, B, prenet_dim]
    bool on the CPU: keep = u < 1 - p, with u uniform from a
    ``torch.Generator`` seeded by ``SeedSequence([seed])``."""
    state = np.random.SeedSequence([seed & 0xFFFFFFFF]).generate_state(1)
    gen = torch.Generator().manual_seed(int(state[0]))
    u = torch.rand((max_steps, 2, bsz, cfg.prenet_dim), generator=gen)
    return u < 1.0 - cfg.p_prenet_dropout


def _prenet(p, x: torch.Tensor, keep: typing.Optional[torch.Tensor], p_dropout: float):
    """Two ReLU linears with always-on dropout (the NVIDIA quirk); ``keep``
    [2, B, prenet_dim] holds this step's masks."""
    for i, layer in enumerate(p):
        x = torch.relu(F.linear(x, layer["w"]))
        if p_dropout > 0.0 and keep is not None:
            x = torch.where(keep[i], x / (1.0 - p_dropout), 0.0)
    return x


def _attention(att: Params, query, memory, processed_memory, attn_cat, mask):
    """Location-sensitive attention.

    query [B, A_rnn]; attn_cat [B, T, 2] (current and cumulative weights).
    Returns (context [B, E], weights [B, T])."""
    loc = conv1d(attn_cat, att["location_conv"])  # 'same' padding
    processed = (
        F.linear(query, att["query"]["w"])[:, None, :]
        + F.linear(loc, att["location_dense"]["w"])
        + processed_memory
    )
    energies = F.linear(torch.tanh(processed), att["v"]["w"]).squeeze(-1)  # [B, T]
    energies = torch.where(mask > 0, energies, _MASK_VALUE)
    weights = torch.softmax(energies, dim=-1)
    context = torch.bmm(weights[:, None, :], memory).squeeze(1)
    return context, weights


def _decoder_state0(cfg: Tacotron2Config, bsz: int, t: int, like: torch.Tensor) -> dict:
    def zeros(*shape):
        return like.new_zeros(shape)

    return {
        "attn_h": zeros(bsz, cfg.attention_rnn_dim),
        "attn_c": zeros(bsz, cfg.attention_rnn_dim),
        "dec_h": zeros(bsz, cfg.decoder_rnn_dim),
        "dec_c": zeros(bsz, cfg.decoder_rnn_dim),
        "attn_w": zeros(bsz, t),
        "attn_w_cum": zeros(bsz, t),
        "context": zeros(bsz, cfg.encoder_embedding_dim),
    }


def _decoder_step(
    params: Params,
    cfg: Tacotron2Config,
    state: dict,
    prenet_out: torch.Tensor,
    memory: torch.Tensor,
    processed_memory: torch.Tensor,
    mask: torch.Tensor,
):
    """One frame: returns (new_state, mel_frame [B, M], gate_logit [B])."""
    dec = params["decoder"]
    cell_in = torch.cat([prenet_out, state["context"]], dim=-1)
    attn_h, attn_c = lstm_cell(dec["attention_rnn"], cell_in, state["attn_h"], state["attn_c"])
    attn_cat = torch.stack([state["attn_w"], state["attn_w_cum"]], dim=-1)
    context, weights = _attention(
        dec["attention"], attn_h, memory, processed_memory, attn_cat, mask
    )
    dec_h, dec_c = lstm_cell(
        dec["decoder_rnn"], torch.cat([attn_h, context], dim=-1), state["dec_h"], state["dec_c"]
    )
    proj_in = torch.cat([dec_h, context], dim=-1)
    mel = F.linear(proj_in, dec["projection"]["w"], dec["projection"]["b"])
    gate = F.linear(proj_in, dec["gate"]["w"], dec["gate"]["b"]).squeeze(-1)
    new_state = {
        "attn_h": attn_h,
        "attn_c": attn_c,
        "dec_h": dec_h,
        "dec_c": dec_c,
        "attn_w": weights,
        "attn_w_cum": state["attn_w_cum"] + weights,
        "context": context,
    }
    return new_state, mel, gate


def decode_inference(
    params: Params,
    cfg: Tacotron2Config,
    memory: torch.Tensor,
    mask: torch.Tensor,
    max_steps: int,
    keep_masks: typing.Optional[torch.Tensor] = None,
):
    """Autoregressive decode over every one of ``max_steps`` steps.

    ``keep_masks`` [max_steps, 2, B, prenet_dim] (bool) turns the prenet
    dropout on; None runs without it.  Returns (mels [B, S, M], gate_logits
    [B, S], lengths [B] int32), where a length counts frames up to and
    including the stop-token frame, or ``max_steps`` if the gate never
    fired.  Frames after the stop are computed too (the postnet sees them):
    crop on the host."""
    dec = params["decoder"]
    bsz, t, _ = memory.shape
    processed_memory = F.linear(memory, dec["attention"]["memory"]["w"])
    state = _decoder_state0(cfg, bsz, t, memory)
    prev = memory.new_zeros((bsz, cfg.mel_channels))
    finished = torch.zeros((bsz,), dtype=torch.bool, device=memory.device)
    lengths = torch.zeros((bsz,), dtype=torch.int32, device=memory.device)
    mels, gates = [], []
    for i in range(max_steps):
        keep = None if keep_masks is None else keep_masks[i]
        pre = _prenet(dec["prenet"], prev, keep, cfg.p_prenet_dropout)
        state, prev, gate = _decoder_step(
            params, cfg, state, pre, memory, processed_memory, mask
        )
        # length = where(finished, length, i + 1), before finished |= stop
        lengths += (~finished).to(torch.int32)
        finished = finished | (torch.sigmoid(gate) > cfg.gate_threshold)
        mels.append(prev)
        gates.append(gate)
    return torch.stack(mels, dim=1), torch.stack(gates, dim=1), lengths


# -----------------------------------------------------------------------------
# Postnet + top level


def postnet(params: Params, cfg: Tacotron2Config, mels: torch.Tensor) -> torch.Tensor:
    """5-conv residual refiner: mels [B, S, M] -> residual [B, S, M]."""
    x = mels
    convs = params["postnet"]["convs"]
    for i, conv in enumerate(convs):
        x = _bn(conv["bn"], conv1d(x, conv["w"], conv["b"]))
        if i < len(convs) - 1:
            x = torch.tanh(x)
    return x


def infer(
    params: Params,
    cfg: Tacotron2Config,
    ids: torch.Tensor,
    lengths: typing.Optional[torch.Tensor] = None,
    max_steps: typing.Optional[int] = None,
    keep_masks: typing.Optional[torch.Tensor] = None,
):
    """Full inference: ids [B, T] -> (mel_post [B, S, M], lengths [B])."""
    if max_steps is None:
        max_steps = cfg.max_decoder_steps
    memory, mask = encode(params, cfg, ids, lengths)
    mels, _, out_lengths = decode_inference(params, cfg, memory, mask, max_steps, keep_masks)
    return mels + postnet(params, cfg, mels), out_lengths
