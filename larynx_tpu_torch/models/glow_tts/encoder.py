"""GlowTTS text encoder: relative-position transformer + duration predictor.

Counterpart of ``larynx_tpu/models/glow_tts/encoder.py``, channels-last
[B, T, C].  Per-layer params are stacked on a leading axis (as in the
native checkpoint) and run in a Python loop.  The relative-position logits
use the same O(T * (2T-1)) pad/reshape skewing as the JAX package.
Dropout is omitted.  Tensor parallel (training on a mesh, ``tp`` a
``parallel/train.py::ModelAxis``): each model rank holds whole heads of
q/k/v and the matching input rows of the output projection, and a slice of
the FFN's filters (``weights.py::GLOW_TP_AXES``); the layer input enters
through ``tp.copy`` and the two row-parallel products leave through
``tp.reduce``, their biases added once after it.  The relative-position
embeddings are shared by the heads: replicated, entering through
``tp.copy`` so that their gradient sums every rank's heads.  The norms, the
prenet and the duration predictor stay replicated.  In bfloat16 (``half``) the attention
scores, softmax and weighted sums run in float32, as the JAX package's
einsums accumulate, and return to bfloat16 before the output projection.
"""

import typing

import torch
import torch.nn.functional as F

from larynx_tpu_torch.models.glow_tts.config import GlowTTSConfig
from larynx_tpu_torch.models.nn import conv1d, layer_norm, matmul1x1

Params = typing.Dict[str, typing.Any]

ATTN_MASK_VALUE = -1e4  # reference uses masked_fill(-1e4), not -inf


def _pad_relative_embeddings(emb: torch.Tensor, length: int, window: int):
    """[2w+1, d] learned embeddings -> [2*length-1, d] for sequence length."""
    pad = max(length - (window + 1), 0)
    start = max((window + 1) - length, 0)
    if pad > 0:
        emb = F.pad(emb, (0, 0, pad, pad))
    return emb[start : start + 2 * length - 1]


def _relative_to_absolute(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, 2L-1] relative logits -> [B, H, L, L] absolute."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(b, h, l * 2 * l)
    x = F.pad(x, (0, l - 1)).reshape(b, h, l + 1, 2 * l - 1)
    return x[:, :, :l, l - 1 :]


def _absolute_to_relative(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, L] attention weights -> [B, H, L, 2L-1] relative layout."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1)).reshape(b, h, l * l + l * (l - 1))
    x = F.pad(x, (l, 0)).reshape(b, h, l, 2 * l)
    return x[:, :, :, 1:]


def multi_head_attention(
    p: Params,
    x: torch.Tensor,
    attn_mask: torch.Tensor,
    n_heads: int,
    window_size: typing.Optional[int],
    block_length: typing.Optional[int] = None,
    tp=None,
) -> torch.Tensor:
    """Self-attention with windowed relative-position terms.

    x: [B, T, C]; attn_mask: [B, 1, T, T] bool (True = attend).  The heads
    are those of q_w's rows (all of them, or a model rank's with ``tp``).
    """
    b, t, c = x.shape
    dk = c // n_heads
    local = p["q_w"].shape[0] // dk  # this rank's heads
    if tp is not None:
        x = tp.copy(x)

    def heads(w, bias):
        return matmul1x1(x, w, bias).reshape(b, t, local, dk).transpose(1, 2)

    q = heads(p["q_w"], p["q_b"])  # [B, H, T, dk]
    k = heads(p["k_w"], p["k_b"])
    v = heads(p["v_w"], p["v_b"])

    if x.dtype == torch.float32:
        scale = 1.0 / (dk**0.5)
    else:  # JAX's 1 / sqrt(dk), both steps in the compute dtype
        scale = float(1.0 / torch.sqrt(torch.tensor(float(dk), dtype=x.dtype)))
    wide = torch.promote_types(x.dtype, torch.float32)
    q = q.to(wide)
    scores = torch.matmul(q, k.to(wide).transpose(-1, -2)) * scale
    emb_rel_k, emb_rel_v = p.get("emb_rel_k"), p.get("emb_rel_v")
    if tp is not None and window_size is not None:
        # shared by every head: each model rank's heads give part of their
        # gradient, which the copy's backward sums
        emb_rel_k, emb_rel_v = tp.copy(emb_rel_k), tp.copy(emb_rel_v)
    if window_size is not None:
        rel_k = _pad_relative_embeddings(emb_rel_k, t, window_size)
        rel_logits = torch.matmul(q, rel_k.to(wide).t())  # [B, H, T, 2T-1]
        scores = scores + _relative_to_absolute(rel_logits) * scale

    scores = torch.where(attn_mask, scores, torch.full_like(scores, ATTN_MASK_VALUE))
    if block_length is not None:
        pos = torch.arange(t, device=x.device)
        band = (pos[None, :] - pos[:, None]).abs() <= block_length
        scores = torch.where(band, scores, torch.full_like(scores, ATTN_MASK_VALUE))

    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs, v.to(wide))
    if window_size is not None:
        rel_v = _pad_relative_embeddings(emb_rel_v, t, window_size)
        out = out + torch.matmul(_absolute_to_relative(probs), rel_v.to(wide))

    out = out.to(x.dtype).transpose(1, 2).reshape(b, t, local * dk)
    if tp is None:
        return matmul1x1(out, p["o_w"], p["o_b"])
    return tp.reduce(matmul1x1(out, p["o_w"])) + p["o_b"]


def ffn(p: Params, x: torch.Tensor, mask: torch.Tensor, tp=None) -> torch.Tensor:
    """Conv feed-forward (relu); with ``tp`` over this rank's filters."""
    if tp is None:
        h = torch.relu(conv1d(x * mask, p["conv1_w"], p["conv1_b"]))
        h = conv1d(h * mask, p["conv2_w"], p["conv2_b"])
        return h * mask
    h = torch.relu(conv1d(tp.copy(x) * mask, p["conv1_w"], p["conv1_b"]))
    h = tp.reduce(conv1d(h * mask, p["conv2_w"])) + p["conv2_b"]
    return h * mask


def encoder_stack(
    stacked: Params, x: torch.Tensor, mask: torch.Tensor, cfg: GlowTTSConfig, tp=None
) -> torch.Tensor:
    """n_layers x (rel-MHA + LN residual, conv-FFN + LN residual).

    ``stacked`` holds per-layer params stacked on axis 0 (a model rank's
    slices with ``tp``); ``mask`` is [B, T, 1].
    """
    m = mask[..., 0] > 0
    attn_mask = m[:, None, :, None] & m[:, None, None, :]
    n_layers = stacked["q_w"].shape[0]
    for i in range(n_layers):
        layer_p = {name: value[i] for name, value in stacked.items()}
        h = x * mask
        y = multi_head_attention(
            layer_p, h, attn_mask, cfg.n_heads, cfg.window_size, cfg.block_length, tp=tp
        )
        h = layer_norm(h + y, layer_p["ln1_g"], layer_p["ln1_b"])
        y = ffn(layer_p, h, mask, tp=tp)
        x = layer_norm(h + y, layer_p["ln2_g"], layer_p["ln2_b"])
    return x * mask


def prenet(p: Params, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """ConvReluNorm prenet with residual projection."""
    h = x
    for conv_p in p["layers"]:
        h = conv1d(h * mask, conv_p["w"], conv_p["b"])
        h = torch.relu(layer_norm(h, conv_p["ln_g"], conv_p["ln_b"]))
    h = x + matmul1x1(h, p["proj_w"], p["proj_b"])
    return h * mask


def duration_predictor(p: Params, x: torch.Tensor, mask: torch.Tensor):
    """conv->relu->LN x2 -> 1x1 proj -> log-durations [B, T, 1]."""
    h = conv1d(x * mask, p["conv1_w"], p["conv1_b"])
    h = layer_norm(torch.relu(h), p["ln1_g"], p["ln1_b"])
    h = conv1d(h * mask, p["conv2_w"], p["conv2_b"])
    h = layer_norm(torch.relu(h), p["ln2_g"], p["ln2_b"])
    h = matmul1x1(h * mask, p["proj_w"], p["proj_b"])
    return h * mask
