"""GlowTTS, the acoustic model (``acoustic.kind`` "glow_tts").

Random weights in the port's init scales (``weights.py::init_params``:
uniform 1/sqrt(fan_in) convs, xavier projections, rotations for the
invertible 1x1s), with three departures, each because the init would take a
layer out of the output or speak at no voice's rate:

- the prenet's projection and every coupling's end 1x1 (zero in the init,
  so the prenet and each coupling are the identity) are drawn at
  ``END_SCALE`` x the xavier bound;
- the duration predictor's output 1x1 is drawn at ``DP_SCALE`` x the
  xavier bound: at the full bound a random encoder gives whole sentences
  speaking rates 20x apart (1.3 to 28 frames per id at length scale 6),
  where a voice's sentences differ by tens of percent;
- the duration predictor's output bias is set by :func:`calibrate` so that
  a calibration set of sentences drawn from the mix's law takes the mix's
  ``frames_per_id`` frames per id at its length scale, so that every seed's
  voice speaks at the same rate.

The reference is ``reference/glowtts.py`` (float64).
"""

import math

import torch

from portbench.harness.weights import Draws, rotations, to_dtype
from portbench.reference import glowtts as reference

PORT_CONFIG = "larynx_tpu_torch.models.glow_tts.config:GlowTTSConfig"
END_SCALE = 0.05
DP_SCALE = 0.25


def weights(cfg, gen, device, dtype=torch.float32):
    """The GlowTTS tree (float32, the precision it is served in); its
    duration bias is set by :func:`calibrate`."""
    h, f, fdp, k = cfg["hidden_channels"], cfg["filter_channels"], cfg["filter_channels_dp"], \
        cfg["kernel_size"]
    n_l, mel = cfg["n_layers_enc"], cfg["mel_channels"]
    dk = cfg["hidden_channels"] // cfg["n_heads"]
    w2 = 2 * cfg["window_size"] + 1
    d = Draws()
    enc = {}
    d.normal(enc, "emb", (cfg["num_symbols"], h), h ** -0.5)
    zeros = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    ones = lambda *s: torch.ones(s, device=device)  # noqa: E731
    if cfg.get("prenet", False):
        layers = []
        for _ in range(3):
            layer = {"ln_g": ones(h), "ln_b": zeros(h)}
            d.uniform(layer, "w", (h, h, 5), 1 / math.sqrt(h * 5))
            d.uniform(layer, "b", (h,), 1 / math.sqrt(h * 5))
            layers.append(layer)
        pre = {"layers": layers, "proj_b": zeros(h)}
        d.uniform(pre, "proj_w", (h, h), END_SCALE * math.sqrt(6 / (2 * h)))
        enc["prenet"] = pre
    lay = {}
    for name in ("q", "k", "v", "o"):
        d.uniform(lay, f"{name}_w", (n_l, h, h), math.sqrt(6 / (2 * h)))
        lay[f"{name}_b"] = zeros(n_l, h)
    for name in ("ln1", "ln2"):
        lay[f"{name}_g"], lay[f"{name}_b"] = ones(n_l, h), zeros(n_l, h)
    d.uniform(lay, "conv1_w", (n_l, f, h, k), 1 / math.sqrt(h * k))
    d.uniform(lay, "conv1_b", (n_l, f), 1 / math.sqrt(h * k))
    d.uniform(lay, "conv2_w", (n_l, h, f, k), 1 / math.sqrt(f * k))
    d.uniform(lay, "conv2_b", (n_l, h), 1 / math.sqrt(f * k))
    d.normal(lay, "emb_rel_k", (n_l, w2, dk), dk ** -0.5)
    d.normal(lay, "emb_rel_v", (n_l, w2, dk), dk ** -0.5)
    enc["layers"] = lay
    d.uniform(enc, "proj_m_w", (mel, h), math.sqrt(6 / (h + mel)))
    enc["proj_m_b"] = zeros(mel)
    dp = {"ln1_g": ones(fdp), "ln1_b": zeros(fdp), "ln2_g": ones(fdp), "ln2_b": zeros(fdp),
          "proj_b": zeros(1)}
    d.uniform(dp, "conv1_w", (fdp, h, k), 1 / math.sqrt(h * k))
    d.uniform(dp, "conv1_b", (fdp,), 1 / math.sqrt(h * k))
    d.uniform(dp, "conv2_w", (fdp, fdp, k), 1 / math.sqrt(fdp * k))
    d.uniform(dp, "conv2_b", (fdp,), 1 / math.sqrt(fdp * k))
    d.uniform(dp, "proj_w", (1, fdp), DP_SCALE * math.sqrt(6 / (fdp + 1)))
    enc["dp"] = dp

    nb, nl, kd = cfg["n_blocks_dec"], cfg["n_block_layers"], cfg["kernel_size_dec"]
    cs = mel * cfg["n_sqz"]
    coupling, wn = {"end_b": zeros(nb, cs)}, {}
    d.uniform(coupling, "start_w", (nb, h, cs // 2), 1 / math.sqrt(cs // 2))
    d.uniform(coupling, "start_b", (nb, h), 1 / math.sqrt(cs // 2))
    d.uniform(coupling, "end_w", (nb, cs, h), END_SCALE * math.sqrt(6 / (h + cs)))
    d.uniform(wn, "in_w", (nb, nl, 2 * h, h, kd), 1 / math.sqrt(h * kd))
    d.uniform(wn, "in_b", (nb, nl, 2 * h), 1 / math.sqrt(h * kd))
    d.uniform(wn, "res_skip_w", (nb, nl, 2 * h, h), 1 / math.sqrt(h))
    d.uniform(wn, "res_skip_b", (nb, nl, 2 * h), 1 / math.sqrt(h))
    d.fill(gen, device, dtype)
    # the last WN layer emits its skip alone: the res half of its 1x1 is zero
    wn["res_skip_w"][:, nl - 1, :h] = 0.0
    wn["res_skip_b"][:, nl - 1, :h] = 0.0
    coupling["wn"] = wn
    weight, weight_inv = rotations(gen, nb, cfg["n_split"], device)
    decoder = {
        "actnorm": {"logs": zeros(nb, cs), "bias": zeros(nb, cs)},
        "invconv": {"weight": weight, "weight_inv": weight_inv},
        "coupling": coupling,
    }
    return {"encoder": enc, "decoder": decoder}


def calibrate(params, cfg, ids, lengths, length_scale, frames_per_id):
    """Set the duration predictor's output bias so that the valid tokens of
    (ids, lengths) take ``frames_per_id`` frames each on average (the
    ceiling of their durations at ``length_scale``), through the reference
    encoder in float64; the bias shifts every log-duration alike, so a
    bisection on it finds the rate."""
    params["encoder"]["dp"]["proj_b"].zero_()
    with torch.no_grad():
        enc = reference.encode(to_dtype(params, torch.float64), cfg, ids, lengths, 1.0)
    mask = enc["mask"][:, 0] > 0
    logw = enc["logw"][mask]
    lo, hi = -20.0, 20.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if float(torch.ceil(length_scale * torch.exp(logw + mid)).mean()) < frames_per_id:
            lo = mid
        else:
            hi = mid
    params["encoder"]["dp"]["proj_b"].fill_(0.5 * (lo + hi))


def flops(cfg, n_ids, frames):
    """A request's encode over its ids and flow decode over its valid frames."""
    return glow_encode_flops(cfg, n_ids) + glow_decode_flops(cfg, frames)


def glow_encode_flops(cfg, n_ids):
    h, f, k = cfg["hidden_channels"], cfg["filter_channels"], cfg["kernel_size"]
    fdp, mel = cfg["filter_channels_dp"], cfg["mel_channels"]
    w = cfg["window_size"] or 0
    per_id = 0
    if cfg.get("prenet", False):
        per_id += 3 * 5 * h * h + h * h
    per_layer = 4 * h * h + 2 * k * h * f
    attn = 2 * n_ids * h + 2 * (2 * w + 1) * h  # q.k and p.v over the sentence, the window's terms
    per_id += cfg["n_layers_enc"] * (per_layer + attn)
    per_id += h * mel + k * h * fdp + k * fdp * fdp + fdp
    return 2.0 * n_ids * per_id


def glow_decode_flops(cfg, frames):
    h, mel, n_sqz = cfg["hidden_channels"], cfg["mel_channels"], cfg["n_sqz"]
    cs = mel * n_sqz
    wn = cfg["n_block_layers"] * (cfg["kernel_size_dec"] * h * 2 * h + 2 * h * h)
    per_pos = (cs // 2) * h + wn \
        + h * cs + cs * (cs // cfg["n_split"])
    return 2.0 * (frames // n_sqz) * cfg["n_blocks_dec"] * per_pos
