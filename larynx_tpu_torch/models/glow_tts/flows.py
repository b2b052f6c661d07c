"""GlowTTS normalizing-flow decoder, inference (reverse) direction.

Counterpart of ``larynx_tpu/models/glow_tts/flows.py``, channels-last
[B, T, C].  Block params are stacked on a leading axis (as in the native
checkpoint) and the reverse pass walks the blocks last to first.  The WN
last layer's res half is zero-padded in the params, so every layer has the
same shape; 1x1 invertible-conv inverses come precomputed in the params.
A multi-speaker voice's couplings carry a cond 1x1 (``cond_w`` [1, 2h * L,
gin], ``cond_b``) that maps the speaker embedding into every WaveNet layer.
Every step runs in the tensors' dtype; in bfloat16 (``half``) the grouped
invertible 1x1 is computed in float32 and cast back, as in the JAX package.
"""

import typing

import torch

from larynx_tpu_torch.models.glow_tts.config import GlowTTSConfig
from larynx_tpu_torch.models.nn import conv1d, matmul1x1

Params = typing.Dict[str, typing.Any]


def squeeze(x: torch.Tensor, mask: torch.Tensor, n_sqz: int):
    """[B, T, C] -> [B, T//n, n*C]; channel block s holds time offset s.

    The mask keeps index n-1 of each group: a group is valid only if its
    last frame is.
    """
    b, t, c = x.shape
    t_trunc = (t // n_sqz) * n_sqz
    x = x[:, :t_trunc].reshape(b, t_trunc // n_sqz, n_sqz * c)
    sub_mask = mask[:, n_sqz - 1 : t_trunc : n_sqz]
    return x * sub_mask[..., None], sub_mask


def unsqueeze(x: torch.Tensor, mask: torch.Tensor, n_sqz: int):
    """[B, T', n*C] -> [B, T'*n, C]; inverse of :func:`squeeze`."""
    b, t, nc = x.shape
    x = x.reshape(b, t * n_sqz, nc // n_sqz)
    full_mask = torch.repeat_interleave(mask, n_sqz, dim=1)
    return x * full_mask[..., None], full_mask


def actnorm_reverse(p: Params, x, mask):
    """Inverse per-channel affine."""
    return (x - p["bias"]) * torch.exp(-p["logs"]) * mask[..., None]


def _group_split(x: torch.Tensor, n_split: int):
    """[B, T, C] -> [B, T, n_split, C//n_split] with the reference's exact
    (2, C//n_split, n_split//2) factorization of the channel axis."""
    b, t, c = x.shape
    x = x.reshape(b, t, 2, c // n_split, n_split // 2).permute(0, 1, 2, 4, 3)
    return x.reshape(b, t, n_split, c // n_split)


def _group_merge(x: torch.Tensor, c: int):
    """Inverse of :func:`_group_split`."""
    b, t, n_split, _ = x.shape
    x = x.reshape(b, t, 2, n_split // 2, c // n_split).permute(0, 1, 2, 4, 3)
    return x.reshape(b, t, c)


def inv_conv_near_reverse(p: Params, x, mask, n_split: int):
    """Inverse of the invertible 1x1 conv over channel groups."""
    c = x.shape[-1]
    grouped = _group_split(x, n_split)  # [B, T, S, C/S]
    mixed = torch.einsum("sk,btkc->btsc", p["weight_inv"].float(), grouped.float()).to(x.dtype)
    return _group_merge(mixed, c) * mask[..., None]


def wavenet(p: Params, x, mask, dilation_rate: int = 1, g=None):
    """Gated dilated-conv WaveNet stack; layer i uses dilation rate**i.

    ``g`` is the speaker conditioning [B, 1, 2h * n_layers] out of the
    coupling's cond 1x1: layer i adds its 2h slice before the gate."""
    n_layers = p["in_w"].shape[0]
    h = x.shape[-1]
    mask1 = mask[..., None]
    output = torch.zeros_like(x)
    for i in range(n_layers):
        x_in = conv1d(x, p["in_w"][i], p["in_b"][i], dilation=dilation_rate**i)
        if g is not None:
            x_in = x_in + g[..., i * 2 * h : (i + 1) * 2 * h]
        acts = torch.tanh(x_in[..., :h]) * torch.sigmoid(x_in[..., h:])
        res_skip = matmul1x1(acts, p["res_skip_w"][i], p["res_skip_b"][i])
        x = (x + res_skip[..., :h]) * mask1
        output = output + res_skip[..., h:]
    return output * mask1


def coupling_reverse(p: Params, x, mask, cfg: GlowTTSConfig, g=None):
    """Inverse affine coupling block; ``g`` [B, gin] is the normalised
    speaker embedding, which a multi-speaker voice's cond 1x1 maps to the
    WaveNet's conditioning."""
    half = x.shape[-1] // 2
    x0, x1 = x[..., :half], x[..., half:]
    g_cond = None
    if g is not None and "cond_w" in p["wn"]:
        g_cond = matmul1x1(g, p["wn"]["cond_w"][0], p["wn"]["cond_b"])[:, None, :]
    h = matmul1x1(x0, p["start_w"], p["start_b"]) * mask[..., None]
    h = wavenet(p["wn"], h, mask, dilation_rate=cfg.dilation_rate, g=g_cond)
    out = matmul1x1(h, p["end_w"], p["end_b"])
    m, logs = out[..., :half], out[..., half:]
    if cfg.sigmoid_scale:
        logs = torch.log(1e-6 + torch.sigmoid(logs + 2))
    z1 = (x1 - m) * torch.exp(-logs) * mask[..., None]
    return torch.cat([x0, z1], dim=-1)


def _block(stacked: Params, i: int) -> Params:
    """Params of block ``i`` out of the stacked tree."""
    if isinstance(stacked, dict):
        return {k: _block(v, i) for k, v in stacked.items()}
    return stacked[i]


def decoder_reverse(
    stacked_blocks: Params, x: torch.Tensor, mask: torch.Tensor, cfg: GlowTTSConfig, g=None
) -> torch.Tensor:
    """Reverse flow: latent [B, T, C] -> mel [B, T, C]; ``g`` as in
    :func:`coupling_reverse`."""
    if cfg.n_sqz > 1:
        x, sq_mask = squeeze(x, mask, cfg.n_sqz)
    else:
        sq_mask = mask
    n_blocks = stacked_blocks["actnorm"]["logs"].shape[0]
    for i in reversed(range(n_blocks)):
        p = _block(stacked_blocks, i)
        x = coupling_reverse(p["coupling"], x, sq_mask, cfg, g=g)
        x = inv_conv_near_reverse(p["invconv"], x, sq_mask, cfg.n_split)
        x = actnorm_reverse(p["actnorm"], x, sq_mask)
    if cfg.n_sqz > 1:
        x, _ = unsqueeze(x, sq_mask, cfg.n_sqz)
    return x
