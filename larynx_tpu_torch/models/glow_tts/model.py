"""GlowTTS inference in two stages, as in ``larynx_tpu/models/glow_tts/model.py``.

  stage A  ``encode``            ids [B,T] -> (x_m, x_logs, logw, w_ceil,
                                 y_lengths, x_mask)
  stage B  ``expand_and_decode`` expand means to [B,M,C] by a cumsum
                                 compare, sample, run the reverse flow.

Latent noise is an optional tensor argument; when absent it is drawn from
an explicit ``torch.Generator``.  A multi-speaker voice takes ``g``, the
L2-normalised speaker embedding (:func:`speaker_embedding`), in the duration
predictor's input and in every flow coupling.  The params'
dtype is the compute dtype (bfloat16 with ``half``): the masks and the
latent noise take it, the duration math stays float32.  :func:`pack_params`
adds the flow WaveNets' kernel weights, once, at load.
"""

import math
import typing

import torch

from larynx_tpu_torch.models.glow_tts import encoder as enc
from larynx_tpu_torch.models.glow_tts import flows
from larynx_tpu_torch.models.glow_tts.config import GlowTTSConfig
from larynx_tpu_torch.models.nn import matmul1x1, sequence_mask
from larynx_tpu_torch.ops import flow_wn

Params = typing.Dict[str, typing.Any]


def pack_params(params: Params) -> Params:
    """params plus, where the kernel takes the flow's WaveNet geometry
    (hidden 192, odd k <= 5) and the params are float32, each coupling's
    packed layer weights: ``decoder.coupling.wn.flow_wn`` [blocks, L, n]
    (``ops/flow_wn.py::pack_stack``), which routes the reverse flow's
    WaveNets on CUDA through the kernel.  Call once, on the device the
    params run on."""
    wn = params["decoder"]["coupling"]["wn"]
    _blocks, _layers, _two_h, h, k = wn["in_w"].shape
    if wn["in_w"].dtype != torch.float32 or not flow_wn.packs(h, k):
        return params
    packed = torch.stack([flow_wn.pack_stack(w_in, w_rs)
                          for w_in, w_rs in zip(wn["in_w"], wn["res_skip_w"])])
    coupling = dict(params["decoder"]["coupling"], wn=dict(wn, flow_wn=packed))
    return dict(params, decoder=dict(params["decoder"], coupling=coupling))


def encode(
    params: Params,
    cfg: GlowTTSConfig,
    ids: torch.Tensor,
    lengths: torch.Tensor,
    length_scale: typing.Union[float, torch.Tensor] = 1.0,
    g: typing.Optional[torch.Tensor] = None,
    tp=None,
):
    """ids [B, T] -> (x_m, x_logs, logw, w_ceil, y_lengths, x_mask).

    ``g`` [B, gin] is broadcast over T and concatenated to the duration
    predictor's input.  ``tp``: the encoder layers run tensor parallel on
    this model rank's slices (training on a mesh, ``encoder_stack``).  The duration math stays float32: exp -> ceil -> y_lengths floored to a
    multiple of n_sqz, at least n_sqz.
    """
    p = params["encoder"]
    t = ids.shape[1]
    # the compute dtype, so that mask products keep bfloat16 params bfloat16
    mask = sequence_mask(lengths, t, p["emb"].dtype)  # [B, T]
    mask1 = mask[..., None]

    x = p["emb"][ids] * math.sqrt(cfg.enc_channels)
    if cfg.prenet:
        x = enc.prenet(p["prenet"], x, mask1)
    x = enc.encoder_stack(p["layers"], x, mask1, cfg, tp=tp)

    x_m = matmul1x1(x, p["proj_m_w"], p["proj_m_b"]) * mask1
    if cfg.mean_only:
        x_logs = torch.zeros_like(x_m)
    else:
        x_logs = matmul1x1(x, p["proj_s_w"], p["proj_s_b"]) * mask1

    # the duration loss trains the duration predictor alone, not the encoder
    x_dp = x.detach()
    if g is not None:
        x_dp = torch.cat([x_dp, g[:, None, :].expand(x.shape[0], t, g.shape[-1])], dim=-1)
    logw = enc.duration_predictor(p["dp"], x_dp, mask1)[..., 0]  # [B, T]
    w = torch.exp(logw.float()) * mask.float() * length_scale
    w_ceil = torch.ceil(w)
    y_lengths = torch.clamp(w_ceil.sum(dim=1), min=1)
    y_lengths = (y_lengths.to(torch.int32) // cfg.n_sqz) * cfg.n_sqz
    y_lengths = torch.clamp(y_lengths, min=cfg.n_sqz)
    return x_m, x_logs, logw, w_ceil, y_lengths, mask


def expand_and_decode(
    params: Params,
    cfg: GlowTTSConfig,
    x_m: torch.Tensor,
    x_logs: torch.Tensor,
    w_ceil: torch.Tensor,
    y_lengths: torch.Tensor,
    mel_max_length: int,
    noise_scale: typing.Union[float, torch.Tensor] = 1.0,
    noise: typing.Optional[torch.Tensor] = None,
    generator: typing.Optional[torch.Generator] = None,
    g: typing.Optional[torch.Tensor] = None,
):
    """(x_m [B,T,C], durations [B,T]) -> mel [B, M, C], mel mask [B, M].

    ``mel_max_length`` (M) must be >= max(y_lengths) and a multiple of
    n_sqz.  ``noise`` [B, M, C] is the standard-normal latent noise; when
    None it is drawn from ``generator``.  The noise, its scale and the mel
    mask take x_m's dtype.  ``g`` [B, gin] conditions the flow's couplings
    (a multi-speaker voice).
    """
    b, t, c = x_m.shape
    m = mel_max_length

    cum = torch.cumsum(w_ceil, dim=1)  # [B, T]
    frames = torch.arange(m, device=cum.device, dtype=cum.dtype)
    # phoneme index of each frame: #{i : cum[i] <= frame}
    idx = (cum[:, :, None] <= frames[None, None, :]).to(torch.int64).sum(dim=1)
    in_range = idx < t  # frames beyond the total duration get zeros
    idx = torch.clamp(idx, max=t - 1)

    gather_idx = idx[..., None].expand(b, m, c)
    valid = in_range[..., None].to(x_m.dtype)
    z_m = torch.gather(x_m, 1, gather_idx) * valid
    z_logs = torch.gather(x_logs, 1, gather_idx) * valid

    z_mask = sequence_mask(y_lengths, m, x_m.dtype)  # [B, M]
    if noise is None:
        noise = torch.randn(
            (b, m, c), generator=generator, device=x_m.device, dtype=x_m.dtype
        )
    noise = noise.to(x_m.dtype)
    noise_scale = torch.as_tensor(noise_scale, dtype=x_m.dtype, device=x_m.device)
    z = (z_m + torch.exp(z_logs) * noise * noise_scale) * z_mask[..., None]
    mel, _ = flows.decoder(params["decoder"], z, z_mask, cfg, reverse=True, g=g)
    return mel, z_mask


def decode_reverse(params: Params, cfg: GlowTTSConfig, z, z_mask, g=None):
    """Raw reverse flow: latent [B, M, C] -> mel [B, M, C]."""
    return flows.decoder(params["decoder"], z, z_mask, cfg, reverse=True, g=g)[0]


def speaker_embedding(params: Params, speaker_id: torch.Tensor) -> torch.Tensor:
    """The L2-normalised ``emb_g`` rows of speaker indices [B] -> [B, gin]."""
    g = params["emb_g"][speaker_id]
    return g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)
