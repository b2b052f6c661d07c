"""WaveGlow vocoder: mel [B, M, n_mels] -> waveform [B, M * stride], and the
training direction.

Counterpart of ``larynx_tpu/models/waveglow/model.py``.  Audio samples fold into ``groups`` channels per time block; the mel is
upsampled by a transposed conv and folded the same way as conditioning.
Inference walks the flows backwards: per flow, the WN stack conditioned on
the mel gives the affine coupling's (b, log_s), the coupling is inverted and
the invertible 1x1 undone; every ``early_every`` flows, ``early_size``
channels of the prior enter.

Every WN layer runs through ``ops.wn_layer.fused_wn_layer_state``, one
kernel launch per layer on CUDA, as the JAX package runs it through its
Pallas kernel; :func:`pack_params` packs the layers' weights once, at load.
The start and end 1x1s, the invertible 1x1 and the coupling stay plain
torch.  The upsampler is a plain transposed conv trimmed to M * stride: the
JAX package's phased matmul form only works around XLA's lowering.

``infer`` runs in its params' dtype: float32, or bfloat16 (the JAX engine's
vocoder precision on an accelerator), with the mel, the prior, the WN
layers (the kernel's bfloat16 instantiation), the coupling's exp(-log_s)
and the invertible 1x1s' inverses, cast from the float32 ones at load, all
bfloat16.

``forward`` (audio -> z and the log-determinants) and ``loss_fn`` (the
negative log-likelihood) train on the unpacked params: their WN stacks run
unfused (:func:`_wn_unfused`, torch ops under autograd), as the JAX package
trains without its Pallas kernel; the kernel has no backward.
"""

import typing

import torch
import torch.nn.functional as F

from larynx_tpu_torch.models.nn import conv1d
from larynx_tpu_torch.models.waveglow.config import WaveGlowConfig
from larynx_tpu_torch.ops.wn_layer import fused_wn_layer_state, pack_wn_layer
from larynx_tpu_torch.runtime import trace

Params = typing.Dict[str, typing.Any]


def pack_params(params: Params, cfg: WaveGlowConfig) -> Params:
    """params plus, per flow, ``wn["layers"]``: the :class:`WNLayer` of each
    WN layer, with layer i's rows ``[2ch*i, 2ch*(i+1))`` of the stack's
    conditioning 1x1, packed in the params' dtype.  Call once, on the device
    and in the dtype the vocoder runs in."""
    flows = []
    for flow in params["flows"]:
        wn = flow["wn"]
        two_ch = wn["in_w"][0].shape[0]
        layers = []
        for i in range(cfg.wn_layers):
            rows = slice(i * two_ch, (i + 1) * two_ch)
            layers.append(pack_wn_layer(
                wn["in_w"][i], wn["in_b"][i], wn["cond_w"][rows], wn["cond_b"][rows],
                wn["res_skip_w"][i], wn["res_skip_b"][i],
            ))
        flows.append(dict(flow, wn=dict(wn, layers=layers)))
    return dict(params, flows=flows)


def _upsample_cond(params: Params, cfg: WaveGlowConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, M, n_mels] -> grouped conditioning [B, blocks, n_mels*groups].

    ConvTranspose1d upsample trimmed to M * stride, then ``groups``
    consecutive samples fold into channels as ``mel_ch * groups + offset``.
    """
    up = params["upsample"]
    t = mel.shape[1] * cfg.upsample_stride
    spect = F.conv_transpose1d(mel.transpose(1, 2), up["w"], up["b"], stride=cfg.upsample_stride)
    spect = spect[:, :, :t]  # [B, n_mels, T]
    b = spect.shape[0]
    blocks = t // cfg.groups
    spect = spect.reshape(b, cfg.mel_channels, blocks, cfg.groups).permute(0, 2, 1, 3)
    return spect.reshape(b, blocks, cfg.mel_channels * cfg.groups).contiguous()


def _wn(p: Params, cfg: WaveGlowConfig, x0: torch.Tensor, spect_g: torch.Tensor) -> torch.Tensor:
    """Conditioned WaveNet stack -> coupling (b, log_s) channels.

    x0 [B, blocks, n_half]; spect_g [B, blocks, n_mels*groups]."""
    h = F.linear(x0, p["start_w"], p["start_b"]).contiguous()
    skip = None
    b, t, ch = h.shape
    cc, itemsize = spect_g.shape[-1], h.element_size()
    for i, layer in enumerate(p["layers"]):
        first, last = i == 0, i == cfg.wn_layers - 1
        with trace.span("kernel.wn_layer", profile=False, B=b, T=t, ch=ch, cc=cc, first=first,
                        last=last, itemsize=itemsize):
            h, skip = fused_wn_layer_state(
                h, spect_g, skip, layer, dilation=2**i, first=first, last=last,
            )
    return F.linear(skip, p["end_w"], p["end_b"])


def _wn_unfused(p: Params, cfg: WaveGlowConfig, x0: torch.Tensor,
                spect_g: torch.Tensor) -> torch.Tensor:
    """:func:`_wn` as torch ops on the unpacked weights, differentiable: per
    layer the dilated conv plus layer i's slice of the conditioning 1x1, the
    tanh-sigmoid gate, and the res/skip 1x1."""
    ch = p["in_w"][0].shape[0] // 2
    h = F.linear(x0, p["start_w"], p["start_b"])
    skip = None
    for i in range(cfg.wn_layers):
        rows = slice(2 * ch * i, 2 * ch * (i + 1))
        a = (conv1d(h, p["in_w"][i], p["in_b"][i], dilation=2**i)
             + F.linear(spect_g, p["cond_w"][rows], p["cond_b"][rows]))
        acts = torch.tanh(a[..., :ch]) * torch.sigmoid(a[..., ch:])
        rs = F.linear(acts, p["res_skip_w"][i], p["res_skip_b"][i])
        if i < cfg.wn_layers - 1:
            h = h + rs[..., :ch]
            s = rs[..., ch:]
        else:
            s = rs
        skip = s if skip is None else skip + s
    return F.linear(skip, p["end_w"], p["end_b"])


def _group_audio(audio: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, T] -> [B, T//groups, groups] (consecutive samples as channels)."""
    b, t = audio.shape
    return audio[:, : (t // groups) * groups].reshape(b, t // groups, groups)


def forward(
    params: Params, cfg: WaveGlowConfig, audio: torch.Tensor, mel: torch.Tensor
) -> typing.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The training direction: audio [B, T] (T == M * upsample_stride), mel
    [B, M, n_mels] -> (z [B, blocks, groups], log_s_total [B],
    logdet_w_total [B]); unpacked params, unfused WN stacks."""
    cond = _upsample_cond(params, cfg, mel)
    x = _group_audio(audio, cfg.groups)
    blocks = x.shape[1]
    outputs = []
    log_s_total = x.new_zeros(x.shape[0])
    logdet_w_total = x.new_zeros(x.shape[0])
    for k, flow in enumerate(params["flows"]):
        if k % cfg.early_every == 0 and k > 0:
            outputs.append(x[..., : cfg.early_size])
            x = x[..., cfg.early_size :]
        w = flow["convinv"]["w"]
        x = F.linear(x, w)  # einsum("btc,dc->btd")
        logdet_w_total = logdet_w_total + blocks * torch.linalg.slogdet(w)[1]
        n_half = x.shape[-1] // 2
        x0, x1 = x[..., :n_half], x[..., n_half:]
        out = _wn_unfused(flow["wn"], cfg, x0, cond)
        b_t, log_s = out[..., :n_half], out[..., n_half:]
        x1 = x1 * torch.exp(log_s) + b_t
        log_s_total = log_s_total + log_s.sum(dim=(1, 2))
        x = torch.cat([x0, x1], dim=-1)
    outputs.append(x)
    return torch.cat(outputs, dim=-1), log_s_total, logdet_w_total


def loss_fn(params: Params, cfg: WaveGlowConfig, audio: torch.Tensor, mel: torch.Tensor,
            sigma: float = 1.0) -> torch.Tensor:
    """WaveGlow's negative log-likelihood (the paper's eq. 6), per element:
    (sum(z^2) / (2 sigma^2) - sum(log_s) - sum(log|det W|)) / z.numel()."""
    z, log_s_total, logdet_w_total = forward(params, cfg, audio, mel)
    return (torch.sum(z * z) / (2.0 * sigma * sigma) - torch.sum(log_s_total)
            - torch.sum(logdet_w_total)) / z.numel()


def infer(
    params: Params,
    cfg: WaveGlowConfig,
    mel: torch.Tensor,
    z: typing.Optional[torch.Tensor] = None,
    generator: typing.Optional[torch.Generator] = None,
    sigma: float = 1.0,
) -> torch.Tensor:
    """mel [B, M, n_mels] -> audio [B, M * upsample_stride]; ``params``
    from :func:`pack_params`, mel and ``z`` in their dtype.

    ``z`` ([B, blocks, groups], the forward output layout) is the prior;
    without it, ``sigma * N(0, 1)`` is drawn from ``generator``.
    """
    cond = _upsample_cond(params, cfg, mel)
    b, blocks = cond.shape[0], cond.shape[1]
    if z is None:
        z = sigma * torch.randn(
            (b, blocks, cfg.groups), generator=generator, device=mel.device, dtype=mel.dtype
        )

    # the forward pass emits early chunks first and the residual tail last:
    # walk the same layout backwards
    early_flows = [k for k in range(cfg.flows) if k % cfg.early_every == 0 and k > 0]
    offs = 0
    chunks = {}
    for k in early_flows:
        chunks[k] = z[..., offs : offs + cfg.early_size]
        offs += cfg.early_size
    x = z[..., offs:]

    for k in reversed(range(cfg.flows)):
        flow = params["flows"][k]
        n_half = x.shape[-1] // 2
        x0, x1 = x[..., :n_half], x[..., n_half:]
        out = _wn(flow["wn"], cfg, x0, cond)
        b_t, log_s = out[..., :n_half], out[..., n_half:]
        x1 = (x1 - b_t) * torch.exp(-log_s)
        x = torch.cat([x0, x1], dim=-1)
        x = F.linear(x, flow["convinv"]["w_inv"])  # einsum("btc,dc->btd")
        if k in chunks:
            x = torch.cat([chunks[k], x], dim=-1)

    return x.reshape(b, blocks * cfg.groups)
