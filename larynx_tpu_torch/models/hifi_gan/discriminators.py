"""HiFi-GAN discriminators and GAN losses (training only).

Counterpart of ``larynx_tpu/models/hifi_gan/discriminators.py``: the
multi-period discriminator (five periods, a ladder of [5, 1] conv2d with
stride 3 over the audio folded to [T / p, p]) and the multi-scale one
(three scales of grouped conv1d, the audio average-pooled between scales),
with leaky-ReLU 0.1.  Weights are plain (weight norm and spectral norm
folded); activations are in torch's channels-first layout, so the feature
maps are [B, C, T / p, p] and [B, C, T], the JAX package's transposed.
"""

import typing

import numpy as np
import torch
import torch.nn.functional as F

Params = typing.Dict[str, typing.Any]

LRELU_SLOPE = 0.1

PERIODS = (2, 3, 5, 7, 11)

# DiscriminatorP conv ladder: (in, out) channels, kernel 5, stride 3
P_CHANNELS = ((1, 32), (32, 128), (128, 512), (512, 1024))

# DiscriminatorS ladder: (in, out, kernel, stride, groups)
S_LAYERS = (
    (1, 128, 15, 1, 1),
    (128, 128, 41, 2, 4),
    (128, 256, 41, 2, 16),
    (256, 512, 41, 4, 16),
    (512, 1024, 41, 4, 16),
    (1024, 1024, 41, 1, 16),
    (1024, 1024, 5, 1, 1),
)


def _conv2d_p(x, conv, stride):
    """[B, C, H, W] conv with a [C_out, C_in, kh, 1] kernel, stride (s, 1),
    padding (kh - 1) // 2 on H."""
    kh = conv["w"].shape[2]
    return F.conv2d(x, conv["w"], conv["b"], stride=(stride, 1), padding=((kh - 1) // 2, 0))


def discriminator_p(p: Params, audio: torch.Tensor, period: int):
    """One period discriminator: audio [B, T] -> (score [B, N], fmaps):
    reflect-pad to a multiple of the period, fold to [B, 1, T / p, p], the
    conv ladder, flatten."""
    b, t = audio.shape
    if t % period != 0:
        n_pad = period - (t % period)
        audio = F.pad(audio[:, None], (0, n_pad), mode="reflect")[:, 0]
        t = t + n_pad
    x = audio.reshape(b, 1, t // period, period)
    fmap = []
    for i, conv in enumerate(p["convs"]):
        x = F.leaky_relu(_conv2d_p(x, conv, 3 if i < len(p["convs"]) - 1 else 1), LRELU_SLOPE)
        fmap.append(x)
    x = _conv2d_p(x, p["post"], 1)
    fmap.append(x)
    return x.reshape(b, -1), fmap


def discriminator_s(p: Params, audio: torch.Tensor):
    """One scale discriminator: audio [B, T] -> (score [B, N], fmaps)."""
    x = audio[:, None]
    fmap = []
    for conv, (_ci, _co, k, stride, groups) in zip(p["convs"], S_LAYERS):
        x = F.conv1d(x, conv["w"], conv["b"], stride=stride, padding=(k - 1) // 2, groups=groups)
        x = F.leaky_relu(x, LRELU_SLOPE)
        fmap.append(x)
    x = F.conv1d(x, p["post"]["w"], p["post"]["b"], padding=1)
    fmap.append(x)
    return x.reshape(x.shape[0], -1), fmap


def _avg_pool1d(x: torch.Tensor, window: int = 4, stride: int = 2, pad: int = 2) -> torch.Tensor:
    """[B, T] average pool, the padding counted (torch AvgPool1d(4, 2, 2))."""
    return F.avg_pool1d(x[:, None], window, stride, pad, count_include_pad=True)[:, 0]


def multi_period(params: Params, real: torch.Tensor, fake: torch.Tensor):
    """(scores_real, scores_fake, fmaps_real, fmaps_fake) over every period."""
    srs, sgs, frs, fgs = [], [], [], []
    for p, period in zip(params["periods"], PERIODS):
        sr, fr = discriminator_p(p, real, period)
        sg, fg = discriminator_p(p, fake, period)
        srs.append(sr)
        sgs.append(sg)
        frs.append(fr)
        fgs.append(fg)
    return srs, sgs, frs, fgs


def multi_scale(params: Params, real: torch.Tensor, fake: torch.Tensor):
    """The same over the three scales."""
    srs, sgs, frs, fgs = [], [], [], []
    y, y_hat = real, fake
    for i, p in enumerate(params["scales"]):
        if i != 0:
            y, y_hat = _avg_pool1d(y), _avg_pool1d(y_hat)
        sr, fr = discriminator_s(p, y)
        sg, fg = discriminator_s(p, y_hat)
        srs.append(sr)
        sgs.append(sg)
        frs.append(fr)
        fgs.append(fg)
    return srs, sgs, frs, fgs


def feature_loss(fmaps_real, fmaps_fake) -> torch.Tensor:
    loss = 0.0
    for fmap_r, fmap_g in zip(fmaps_real, fmaps_fake):
        for rl, gl in zip(fmap_r, fmap_g):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2.0


def discriminator_loss(scores_real, scores_fake) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(scores_real, scores_fake):
        loss = loss + torch.mean((1.0 - dr).square()) + torch.mean(dg.square())
    return loss


def generator_loss(scores_fake) -> torch.Tensor:
    loss = 0.0
    for dg in scores_fake:
        loss = loss + torch.mean((1.0 - dg).square())
    return loss


def discriminators_from_state_dict(sd: typing.Mapping[str, typing.Any], device=None) -> Params:
    """The reference's MPD + MSD state dicts (prefixes ``mpd.`` / ``msd.``)
    -> the port's tree, with weight norm (``weight_g``/``weight_v``) and
    spectral norm (``weight_orig``/``weight_u``/``weight_v``) folded into
    plain weights; torch's layouts are the port's."""
    sd = {k: np.asarray(v, dtype=np.float64) for k, v in sd.items()}

    def fold(prefix):
        if f"{prefix}.weight_g" in sd:
            v, g = sd[f"{prefix}.weight_v"], sd[f"{prefix}.weight_g"]
            norm = np.sqrt(np.sum(np.square(v), axis=tuple(range(1, v.ndim)), keepdims=True))
            return v * (g / norm)
        if f"{prefix}.weight_orig" in sd:  # W / sigma, sigma = u^T W_mat v
            w = sd[f"{prefix}.weight_orig"]
            sigma = float(sd[f"{prefix}.weight_u"] @ w.reshape(w.shape[0], -1)
                          @ sd[f"{prefix}.weight_v"])
            return w / sigma
        return sd[f"{prefix}.weight"]

    def conv(prefix):
        return {"w": torch.tensor(fold(prefix), dtype=torch.float32, device=device),
                "b": torch.tensor(sd[f"{prefix}.bias"], dtype=torch.float32, device=device)}

    return {
        "periods": [{"convs": [conv(f"mpd.discriminators.{i}.convs.{j}") for j in range(5)],
                     "post": conv(f"mpd.discriminators.{i}.conv_post")}
                    for i in range(len(PERIODS))],
        "scales": [{"convs": [conv(f"msd.discriminators.{i}.convs.{j}") for j in range(7)],
                    "post": conv(f"msd.discriminators.{i}.conv_post")}
                   for i in range(3)],
    }
