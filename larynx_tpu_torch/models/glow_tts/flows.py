"""GlowTTS normalizing-flow decoder, in both directions: forward (training,
mel -> latent with its log-determinant) and reverse (inference).

Counterpart of ``larynx_tpu/models/glow_tts/flows.py``, channels-last
[B, T, C].  Block params are stacked on a leading axis (as in the native
checkpoint); the forward pass walks the blocks first to last, the reverse
pass last to first.  The WN
last layer's res half is zero-padded in the params, so every layer has the
same shape; 1x1 invertible-conv inverses come precomputed in the params.
A multi-speaker voice's couplings carry a cond 1x1 (``cond_w`` [1, 2h * L,
gin], ``cond_b``) that maps the speaker embedding into every WaveNet layer.
Every step runs in the tensors' dtype; in bfloat16 (``half``) the grouped
invertible 1x1 is computed in float32 and cast back, as in the JAX package;
float32 and float64 stay as they are.

On the card each coupling's WaveNet runs one kernel launch a layer
(``ops/flow_wn.py``) where its weights were packed at load
(``model.py::pack_params``) and the input is a CUDA float32 tensor that
needs no gradient; bfloat16, float64, the CPU and training keep the torch
ops.  Counters: ``engine.flow_wn_layers`` (every WaveNet layer, either
route) and ``engine.flow_wn_kernel_layers`` (the kernel's).
"""

import typing

import torch

from larynx_tpu_torch.models.glow_tts.config import GlowTTSConfig
from larynx_tpu_torch.models.nn import conv1d, matmul1x1
from larynx_tpu_torch.ops import flow_wn
from larynx_tpu_torch.runtime import trace

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


def actnorm(p: Params, x, mask, reverse: bool):
    """Per-channel affine -> (z, logdet [B] forward, None reverse)."""
    if reverse:
        return (x - p["bias"]) * torch.exp(-p["logs"]) * mask[..., None], None
    z = (p["bias"] + torch.exp(p["logs"]) * x) * mask[..., None]
    return z, torch.sum(p["logs"]) * mask.sum(dim=1)


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


def inv_conv_near(p: Params, x, mask, n_split: int, reverse: bool):
    """Invertible 1x1 conv over channel groups -> (z, logdet [B] forward,
    None reverse); the reverse direction takes the stored ``weight_inv``.
    The forward logdet is slogdet(weight) * (C / n_split) * length."""
    c = x.shape[-1]
    grouped = _group_split(x, n_split)  # [B, T, S, C/S]
    weight = p["weight_inv"] if reverse else p["weight"]
    at_least_f32 = torch.promote_types(x.dtype, torch.float32)
    mixed = torch.einsum("sk,btkc->btsc", weight.to(at_least_f32),
                         grouped.to(at_least_f32)).to(x.dtype)
    z = _group_merge(mixed, c) * mask[..., None]
    if reverse:
        return z, None
    logabsdet = torch.linalg.slogdet(p["weight"])[1]
    return z, logabsdet * (c / n_split) * mask.sum(dim=1)


def wavenet(p: Params, x, mask, dilation_rate: int = 1, g=None):
    """Gated dilated-conv WaveNet stack; layer i uses dilation rate**i.

    ``g`` is the speaker conditioning [B, 1, 2h * n_layers] out of the
    coupling's cond 1x1: layer i adds its 2h slice before the gate."""
    n_layers = p["in_w"].shape[0]
    trace.count("engine.flow_wn_layers", n_layers)
    if flow_wn.kernel_route(x.device.type, x.dtype, x.requires_grad, "flow_wn" in p):
        return flow_wn.wavenet(p, x, mask, dilation_rate, g)
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


def coupling(p: Params, x, mask, cfg: GlowTTSConfig, reverse: bool, g=None):
    """Affine coupling block -> (z, logdet [B] forward, None reverse);
    ``g`` [B, gin] is the normalised speaker embedding, which a
    multi-speaker voice's cond 1x1 maps to the WaveNet's conditioning."""
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
    if reverse:
        z1 = (x1 - m) * torch.exp(-logs) * mask[..., None]
        logdet = None
    else:
        z1 = (m + torch.exp(logs) * x1) * mask[..., None]
        logdet = torch.sum(logs * mask[..., None], dim=(1, 2))
    return torch.cat([x0, z1], dim=-1), logdet


def flow_step(p: Params, x, mask, cfg: GlowTTSConfig, reverse: bool, g=None):
    """One block: ActNorm -> InvConvNear -> Coupling, or the reverse order
    -> (x, logdet [B] forward, None reverse)."""
    if not reverse:
        x, ld1 = actnorm(p["actnorm"], x, mask, reverse=False)
        x, ld2 = inv_conv_near(p["invconv"], x, mask, cfg.n_split, reverse=False)
        x, ld3 = coupling(p["coupling"], x, mask, cfg, reverse=False, g=g)
        return x, ld1 + ld2 + ld3
    x, _ = coupling(p["coupling"], x, mask, cfg, reverse=True, g=g)
    x, _ = inv_conv_near(p["invconv"], x, mask, cfg.n_split, reverse=True)
    x, _ = actnorm(p["actnorm"], x, mask, reverse=True)
    return x, None


def _block(stacked: Params, i: int) -> Params:
    """Params of block ``i`` out of the stacked tree."""
    if isinstance(stacked, dict):
        return {k: _block(v, i) for k, v in stacked.items()}
    return stacked[i]


def decoder(
    stacked_blocks: Params, x: torch.Tensor, mask: torch.Tensor, cfg: GlowTTSConfig,
    reverse: bool, g=None,
):
    """The whole flow, ``g`` as in :func:`coupling`.  Forward (training):
    mel [B, T, C] -> (latent z, logdet [B]), blocks first to last.  Reverse
    (inference): latent -> (mel, None), blocks last to first."""
    if cfg.n_sqz > 1:
        x, sq_mask = squeeze(x, mask, cfg.n_sqz)
    else:
        sq_mask = mask
    n_blocks = stacked_blocks["actnorm"]["logs"].shape[0]
    logdet = None if reverse else x.new_zeros(x.shape[0], dtype=torch.float32)
    for i in reversed(range(n_blocks)) if reverse else range(n_blocks):
        x, ld = flow_step(_block(stacked_blocks, i), x, sq_mask, cfg, reverse, g=g)
        if not reverse:
            logdet = logdet + ld
    if cfg.n_sqz > 1:
        x, _ = unsqueeze(x, sq_mask, cfg.n_sqz)
    return x, logdet
