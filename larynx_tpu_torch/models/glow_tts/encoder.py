"""GlowTTS text encoder: relative-position transformer + duration predictor.

Counterpart of ``larynx_tpu/models/glow_tts/encoder.py``, channels-last
[B, T, C].  Per-layer params are stacked on a leading axis (as in the
native checkpoint) and run in a Python loop.  The relative-position logits
use the same O(T * (2T-1)) pad/reshape skewing as the JAX package.
Inference only: dropout is omitted.  In bfloat16 (``half``) the attention
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
) -> torch.Tensor:
    """Self-attention with windowed relative-position terms.

    x: [B, T, C]; attn_mask: [B, 1, T, T] bool (True = attend).
    """
    b, t, c = x.shape
    dk = c // n_heads

    def heads(w, bias):
        return matmul1x1(x, w, bias).reshape(b, t, n_heads, dk).transpose(1, 2)

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
    if window_size is not None:
        rel_k = _pad_relative_embeddings(p["emb_rel_k"], t, window_size)
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
        rel_v = _pad_relative_embeddings(p["emb_rel_v"], t, window_size)
        out = out + torch.matmul(_absolute_to_relative(probs), rel_v.to(wide))

    out = out.to(x.dtype).transpose(1, 2).reshape(b, t, c)
    return matmul1x1(out, p["o_w"], p["o_b"])


def ffn(p: Params, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Conv feed-forward (relu)."""
    h = torch.relu(conv1d(x * mask, p["conv1_w"], p["conv1_b"]))
    h = conv1d(h * mask, p["conv2_w"], p["conv2_b"])
    return h * mask


def encoder_stack(
    stacked: Params, x: torch.Tensor, mask: torch.Tensor, cfg: GlowTTSConfig
) -> torch.Tensor:
    """n_layers x (rel-MHA + LN residual, conv-FFN + LN residual).

    ``stacked`` holds per-layer params stacked on axis 0; ``mask`` is
    [B, T, 1].
    """
    m = mask[..., 0] > 0
    attn_mask = m[:, None, :, None] & m[:, None, None, :]
    n_layers = stacked["q_w"].shape[0]
    for i in range(n_layers):
        layer_p = {name: value[i] for name, value in stacked.items()}
        h = x * mask
        y = multi_head_attention(
            layer_p, h, attn_mask, cfg.n_heads, cfg.window_size, cfg.block_length
        )
        h = layer_norm(h + y, layer_p["ln1_g"], layer_p["ln1_b"])
        y = ffn(layer_p, h, mask)
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
