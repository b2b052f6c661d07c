"""The HiFi-GAN generator in plain PyTorch, written from the HiFi-GAN paper
and its published code (github.com/jik876/hifi-gan, ``models.py``):
conv_pre, then per stage leaky ReLU (0.1), a transposed-conv upsample and
the mean of the multi-receptive-field resblocks, then leaky ReLU (0.01,
torch's default in the published ``F.leaky_relu(x)``), conv_post and tanh.

Channels-first ([B, C, T]); parameters in PyTorch's layout (convs [C_out,
C_in, k], transposed convs [C_in, C_out, k]).  ``q`` quantises a conv's
input and weights before it (the lower-precision control); None computes
in the inputs' dtype.
"""

import torch
import torch.nn.functional as F


def _leaky(x, slope):
    return torch.where(x >= 0, x, x * slope)


def _conv(x, p, dilation=1, q=None):
    w, b = p["w"], p["b"]
    if q is not None:
        x, w = q(x), q(w)
    k = w.shape[-1]
    return F.conv1d(x, w.to(x.dtype), b.to(x.dtype), padding=dilation * (k - 1) // 2,
                    dilation=dilation)


def _resblock(p, x, dilations, resblock, q=None):
    if resblock == "1":
        for c1, c2, d in zip(p["convs1"], p["convs2"], dilations):
            xt = _conv(_leaky(x, 0.1), c1, dilation=d, q=q)
            x = _conv(_leaky(xt, 0.1), c2, q=q) + x
        return x
    for c, d in zip(p["convs"], dilations):
        x = _conv(_leaky(x, 0.1), c, dilation=d, q=q) + x
    return x


def generator(params, cfg, mel, q=None):
    """mel [B, num_mels, M] -> audio [B, M * prod(upsample_rates)]."""
    x = _conv(mel, params["conv_pre"], q=q)
    kernels = cfg["resblock_kernel_sizes"]
    nk = len(kernels)
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        x = _leaky(x, 0.1)
        up = params["ups"][i]
        w = up["w"] if q is None else q(up["w"])
        x = F.conv_transpose1d(x if q is None else q(x), w.to(x.dtype), up["b"].to(x.dtype),
                               stride=u, padding=(k - u) // 2)
        acc = 0.0
        for j, dil in enumerate(cfg["resblock_dilation_sizes"]):
            acc = acc + _resblock(params["resblocks"][i * nk + j], x, dil, cfg["resblock"], q=q)
        x = acc / nk
    x = _leaky(x, 0.01)
    x = _conv(x, params["conv_post"], q=q)
    return torch.tanh(x)[:, 0]
