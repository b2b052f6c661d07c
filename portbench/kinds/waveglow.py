"""WaveGlow, a vocoder (``vocoder.kind`` "waveglow"): random weights in the
port's init scales (normal 0.05 for the convs and 1x1s, 0.01 for biases,
rotations for the invertible 1x1s), the plain reference's call
(``reference/waveglow.py``) with the engine's seeded prior, and the FLOPs
of a request.

The init zeroes each coupling's end 1x1, which makes every coupling the
identity; here it is drawn normal at ``END_SCALE``.  At that scale the WN
stacks carry the signal (with every WN layer returning its state unchanged
the audio moves by about its own size) while bfloat16's rounding, which the
flows amplify, stays a few percent; at 0.05 the flows amplify it to more
than the audio itself.
"""

import torch

from portbench.harness.weights import Draws, rotations
from portbench.reference import rules, waveglow

PORT_CONFIG = "larynx_tpu_torch.models.waveglow.config:WaveGlowConfig"
END_SCALE = 0.01
CONTROLS = ("all", "wn")  # every product one step down; the WN products alone


def upsample(cfg):
    return cfg["upsample_stride"]


def engine_kwargs(cfg):
    return {"waveglow_sigma": cfg["sigma"]}


AREA = rules.WAVEGLOW_AREA


def channels_at_flow(cfg, k):
    c = cfg["groups"]
    for i in range(1, k + 1):
        if i % cfg["early_every"] == 0:
            c -= cfg["early_size"]
    return c


def weights(cfg, gen, device, dtype):
    d = Draws()
    mel, ch, nl, g = cfg["mel_channels"], cfg["wn_channels"], cfg["wn_layers"], cfg["groups"]
    params = {"upsample": {}, "flows": []}
    d.normal(params["upsample"], "w", (mel, mel, cfg["upsample_kernel"]), 0.05)
    d.normal(params["upsample"], "b", (mel,), 0.01)
    sizes = [channels_at_flow(cfg, k) for k in range(cfg["flows"])]
    for c in sizes:
        half = c // 2
        wn = {"in_w": [{} for _ in range(nl)], "in_b": [{} for _ in range(nl)],
              "res_skip_w": [{} for _ in range(nl)], "res_skip_b": [{} for _ in range(nl)]}
        d.normal(wn, "start_w", (ch, half), 0.05)
        d.normal(wn, "start_b", (ch,), 0.01)
        d.normal(wn, "cond_w", (2 * ch * nl, mel * g), 0.05)
        d.normal(wn, "cond_b", (2 * ch * nl,), 0.01)
        for i in range(nl):
            rs = 2 * ch if i < nl - 1 else ch
            d.normal(wn["in_w"][i], "v", (2 * ch, ch, cfg["wn_kernel_size"]), 0.05)
            d.normal(wn["in_b"][i], "v", (2 * ch,), 0.01)
            d.normal(wn["res_skip_w"][i], "v", (rs, ch), 0.05)
            d.normal(wn["res_skip_b"][i], "v", (rs,), 0.01)
        d.normal(wn, "end_w", (2 * half, ch), END_SCALE)
        wn["end_b"] = torch.zeros(2 * half, device=device, dtype=dtype)
        params["flows"].append({"wn": wn})
    d.fill(gen, device, dtype)
    for flow in params["flows"]:
        wn = flow["wn"]
        for key in ("in_w", "in_b", "res_skip_w", "res_skip_b"):
            wn[key] = [box["v"] for box in wn[key]]
    for flow, c in zip(params["flows"], sizes):
        w, w_inv = rotations(gen, 1, c, device)
        flow["convinv"] = {"w": w[0].to(dtype), "w_inv": w_inv[0].to(dtype)}
    return params


def prior(engine_seed, batch_index, b_bucket, m, valid_frames, cfg, device):
    """The batch's seeded prior [b_bucket, blocks, groups] (the engine's rule)."""
    return rules.waveglow_prior(engine_seed, batch_index, b_bucket, m, valid_frames, cfg,
                                cfg["sigma"], device)


def vocode(params, cfg, mel, prior, rows, width, q=None, scope="all"):
    """log mel [R, C, W] of the batch's ``rows`` -> float audio [R, W * stride]."""
    blocks = width * cfg["upsample_stride"] // cfg["groups"]
    z = prior[torch.as_tensor(rows, device=prior.device), :blocks].transpose(1, 2)
    return waveglow.infer(params, cfg, mel, z, q=q, wn_only=scope == "wn")


def flops(cfg, frames):
    """WaveGlow over a request's valid frames."""
    return waveglow_flops(cfg, frames)


def waveglow_flops(cfg, frames):
    ch, cc, nl = cfg["wn_channels"], cfg["mel_channels"] * cfg["groups"], cfg["wn_layers"]
    stride, g = cfg["upsample_stride"], cfg["groups"]
    blocks = frames * stride // g
    macs = frames * stride * (cfg["upsample_kernel"] // stride) * cfg["mel_channels"] ** 2
    c = g
    for k in range(cfg["flows"]):
        if k % cfg["early_every"] == 0 and k > 0:
            c -= cfg["early_size"]
        half = c // 2
        wn = sum(2 * ch * (cfg["wn_kernel_size"] * ch + cc) + ch * (2 * ch if i < nl - 1 else ch)
                 for i in range(nl))
        macs += blocks * (half * ch + wn + ch * 2 * half + c * c)
    return 2.0 * macs
