"""Tacotron2, as in ``larynx_tpu/models/tacotron2/model.py``: inference and
the teacher-forced training forward.

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
  ``forward_teacher``   training: ``encode`` and ``postnet`` in train mode
                        (BatchNorm over the batch, encoder dropout) around
                        ``decode_teacher``, the decoder fed the right-shifted
                        targets.

The NVIDIA quirk of prenet dropout at inference is kept.  The JAX package
draws its masks per step from ``fold_in`` keys, whose bits torch cannot
reproduce; the port takes the whole decode's keep masks as one tensor
(:func:`draw_keep_masks`, or injected by a caller), so the decode has no
per-step random launch and the CUDA and CPU runs use the same masks.
Training's dropout masks (encoder and prenet) enter the same way, drawn per
step by ``models/tacotron2/training.py::draw_train_masks``.  Train mode
only applies the two dropouts the JAX package applies: the config's
attention and decoder dropout rates are declared there and never used.
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


def _bn(p: Params, x: torch.Tensor, train: bool = False, eps: float = 1e-5, reduce=None):
    """BatchNorm over the channel axis: with the running statistics, or in
    ``train`` mode with the batch's mean and biased variance over (B, T),
    padded positions included, as JAX.  Returns (y, (mean, var) in train
    mode, else None).  With ``reduce`` (the data group's differentiable
    sum) the statistics are the global batch's, in two passes (the sum and
    the count, then the squared deviations' sum)."""
    if not train:
        mean, var = p["mean"], p["var"]
    elif reduce is None:
        var, mean = torch.var_mean(x, dim=(0, 1), correction=0)
    else:
        c = x.shape[-1]
        count = torch.full((1,), float(x.shape[0] * x.shape[1]), device=x.device, dtype=x.dtype)
        sums = reduce(torch.cat([x.sum(dim=(0, 1)), count]))
        mean = sums[:c] / sums[c]
        var = reduce((x - mean).square().sum(dim=(0, 1))) / sums[c]
    y = (x - mean) * torch.rsqrt(var + eps) * p["gamma"] + p["beta"]
    return y, ((mean, var) if train else None)


def _collect(bn_stats: typing.Optional[list], p: Params, stats, y: torch.Tensor,
             reduce=None) -> None:
    """Append a train-mode BatchNorm's (params, mean, var, n) to
    ``bn_stats``, n = B * T of its output ``y``: the values per channel (a
    tensor, the global batch's, with ``reduce``)."""
    if bn_stats is not None and stats is not None:
        n = y.shape[0] * y.shape[1]
        if reduce is not None:
            n = reduce(torch.tensor(float(n), device=y.device))
        bn_stats.append((p, *stats, n))


# -----------------------------------------------------------------------------
# Encoder


def encode(
    params: Params,
    cfg: Tacotron2Config,
    ids: torch.Tensor,
    lengths: typing.Optional[torch.Tensor] = None,
    train: bool = False,
    keep: typing.Optional[torch.Tensor] = None,
    bn_stats: typing.Optional[list] = None,
    reduce=None,
):
    """ids [B, T] -> (memory [B, T, E], mask [B, T] float {0, 1}).

    Padded positions are zeroed between stages and excluded from attention
    by the mask, so a padded row matches the same row run alone.  In
    ``train`` mode the BatchNorms take the batch's statistics, each
    appended as (bn params, mean, var, n) to ``bn_stats`` if given, and with
    ``keep`` [n_conv, B, T, E] (bool) each conv's ReLU output goes through
    dropout 0.5: ``where(keep, x / 0.5, 0)``; ``reduce`` makes the
    statistics global (:func:`_bn`)."""
    bsz, t = ids.shape
    if lengths is None:
        lengths = torch.full((bsz,), t, dtype=torch.int32, device=ids.device)
    mask = sequence_mask(lengths, t)
    mask1 = mask[..., None]

    x = params["embedding"][ids]  # [B, T, E]
    for i, conv in enumerate(params["encoder"]["convs"]):
        x, stats = _bn(conv["bn"], conv1d(x * mask1, conv["w"], conv["b"]), train, reduce=reduce)
        _collect(bn_stats, conv["bn"], stats, x, reduce)
        x = torch.relu(x)
        if train and keep is not None:
            x = torch.where(keep[i], x / 0.5, 0.0)
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
    [2, *x.shape[:-1], prenet_dim] holds the masks of x's rows (one step's
    [2, B, P] at inference, the whole teacher input's [2, B, S, P] in
    training)."""
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


def decode_teacher(
    params: Params,
    cfg: Tacotron2Config,
    memory: torch.Tensor,
    mask: torch.Tensor,
    mel_targets: torch.Tensor,
    keep: typing.Optional[torch.Tensor] = None,
):
    """Teacher-forced decode for training: the decoder's inputs are the go
    frame, then the targets [B, S, M] shifted right by one frame.  The
    prenet runs over all S inputs at once (it has no state across steps),
    with ``keep`` [2, B, S, prenet_dim] (bool) as its dropout masks; then
    one ``_decoder_step`` per frame.  Returns (mels [B, S, M], gate_logits
    [B, S])."""
    dec = params["decoder"]
    bsz, t, _ = memory.shape
    processed_memory = F.linear(memory, dec["attention"]["memory"]["w"])
    state = _decoder_state0(cfg, bsz, t, memory)
    go = mel_targets.new_zeros((bsz, 1, cfg.mel_channels))
    inputs = torch.cat([go, mel_targets[:, :-1]], dim=1)
    pre = _prenet(dec["prenet"], inputs, keep, cfg.p_prenet_dropout)  # [B, S, P]
    mels, gates = [], []
    for i in range(pre.shape[1]):
        state, mel, gate = _decoder_step(
            params, cfg, state, pre[:, i], memory, processed_memory, mask
        )
        mels.append(mel)
        gates.append(gate)
    return torch.stack(mels, dim=1), torch.stack(gates, dim=1)


# -----------------------------------------------------------------------------
# Postnet + top level


def postnet(params: Params, cfg: Tacotron2Config, mels: torch.Tensor, train: bool = False,
            bn_stats: typing.Optional[list] = None, reduce=None) -> torch.Tensor:
    """5-conv residual refiner: mels [B, S, M] -> residual [B, S, M]; in
    ``train`` mode with batch statistics, as :func:`encode`."""
    x = mels
    convs = params["postnet"]["convs"]
    for i, conv in enumerate(convs):
        x, stats = _bn(conv["bn"], conv1d(x, conv["w"], conv["b"]), train, reduce=reduce)
        _collect(bn_stats, conv["bn"], stats, x, reduce)
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


def forward_teacher(
    params: Params,
    cfg: Tacotron2Config,
    ids: torch.Tensor,
    id_lengths: torch.Tensor,
    mel_targets: torch.Tensor,
    train: bool = True,
    encoder_keep: typing.Optional[torch.Tensor] = None,
    prenet_keep: typing.Optional[torch.Tensor] = None,
    bn_stats: typing.Optional[list] = None,
    reduce=None,
):
    """Training forward: (mel_pre, mel_post, gate_logits).  The keep masks
    ([n_conv, B, T, E] and [2, B, S, prenet_dim], bool) switch the two
    dropouts on; ``bn_stats`` collects the BatchNorms' batch statistics,
    global ones with ``reduce`` (data parallel)."""
    memory, mask = encode(params, cfg, ids, id_lengths, train=train, keep=encoder_keep,
                          bn_stats=bn_stats, reduce=reduce)
    mels, gates = decode_teacher(params, cfg, memory, mask, mel_targets, keep=prenet_keep)
    return mels, mels + postnet(params, cfg, mels, train=train, bn_stats=bn_stats,
                                reduce=reduce), gates
