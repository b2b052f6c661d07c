"""HiFi-GAN, a vocoder (``vocoder.kind`` "hifi_gan"): random weights in the
port's init scales (uniform 1/sqrt(fan_in) for every conv), the plain
reference's call (``reference/hifigan.py``) and the FLOPs of a request.
"""

import math

import numpy as np

from portbench.harness.weights import Draws
from portbench.reference import hifigan, rules

PORT_CONFIG = "larynx_tpu_torch.models.hifi_gan.config:HiFiGanConfig"
AREA = rules.MAX_VOCODE_AREA  # rows x mel frames per vocoder call (the engine's)
CONTROLS = ("all",)


def upsample(cfg):
    return int(np.prod(cfg["upsample_rates"]))


def engine_kwargs(cfg):
    return {}


def weights(cfg, gen, device, dtype):
    d = Draws()
    c0 = cfg["upsample_initial_channel"]

    def conv(c_out, c_in, k, transposed=False):
        p = {}
        shape = (c_in, c_out, k) if transposed else (c_out, c_in, k)
        d.uniform(p, "w", shape, 1 / math.sqrt(c_in * k))
        d.uniform(p, "b", (c_out,), 1 / math.sqrt(c_in * k))
        return p

    params = {"conv_pre": conv(c0, cfg["num_mels"], 7), "ups": [], "resblocks": []}
    ch = c0
    for i, k in enumerate(cfg["upsample_kernel_sizes"]):
        params["ups"].append(conv(c0 // 2 ** (i + 1), ch, k, transposed=True))
        ch = c0 // 2 ** (i + 1)
    for i in range(len(cfg["upsample_rates"])):
        c = c0 // 2 ** (i + 1)
        for ks, ds in zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]):
            if cfg["resblock"] == "1":
                params["resblocks"].append({"convs1": [conv(c, c, ks) for _ in ds],
                                            "convs2": [conv(c, c, ks) for _ in ds]})
            else:
                params["resblocks"].append({"convs": [conv(c, c, ks) for _ in ds]})
    params["conv_post"] = conv(1, ch, 7)
    d.fill(gen, device, dtype)
    return params


def prior(engine_seed, batch_index, b_bucket, m, valid_frames, cfg, device):
    """HiFi-GAN draws nothing: no prior."""
    return None


def vocode(params, cfg, mel, prior, rows, width, q=None, scope="all"):
    """log mel [R, C, W] -> float audio [R, W * upsample]."""
    return hifigan.generator(params, cfg, mel, q=q)


def flops(cfg, frames):
    """The generator over a request's valid frames."""
    return hifigan_flops(cfg, frames)


def hifigan_flops(cfg, frames):
    c0 = cfg["upsample_initial_channel"]
    taps = sum(k * len(d) * (2 if cfg["resblock"] == "1" else 1)
               for k, d in zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]))
    macs = 7 * cfg["num_mels"] * c0  # conv_pre, per frame
    rate, c_in = 1, c0
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        c = c0 // 2 ** (i + 1)
        rate *= u
        macs += rate * ((k // u) * c_in * c + c * c * taps)  # transposed conv, the section
        c_in = c
    macs += rate * 7 * c_in  # conv_post
    return 2.0 * frames * macs
