"""WaveGlow inference in plain PyTorch, written from the WaveGlow paper and
NVIDIA's published code (github.com/NVIDIA/waveglow, ``glow.py``): the mel
upsampled by a transposed conv and folded into ``groups`` channels per
block as the conditioning, then the flows walked backwards, each inverting
its affine coupling (a WaveNet conditioned on the mel gives b and log s)
and its invertible 1x1, with ``early_size`` channels of the prior entering
every ``early_every`` flows.

Channels-first ([B, C, blocks]); parameters in PyTorch's layout: the
upsample [C_in, C_out, k], each WN layer's dilated conv [2ch, ch, k], the
WN's 1x1s [C_out, C_in] (``cond_w`` [2ch * layers, cc], layer i's rows
[2ch * i, 2ch * (i + 1))), ``convinv.w_inv`` [c, c].  ``q`` as in
``hifigan.py``; with ``wn_only`` it quantises the WN stacks' products alone.
"""

import torch
import torch.nn.functional as F


def _lin(x, w, b, q=None):
    if q is not None:
        x, w = q(x), q(w)
    return torch.einsum("oc,bct->bot", w.to(x.dtype), x) + b.to(x.dtype)[None, :, None]


def condition(params, cfg, mel, q=None):
    """mel [B, n_mels, M] -> [B, n_mels * groups, M * stride / groups];
    channel mel_ch * groups + offset holds sample block * groups + offset."""
    up = params["upsample"]
    t = mel.shape[2] * cfg["upsample_stride"]
    w = up["w"] if q is None else q(up["w"])
    spect = F.conv_transpose1d(mel if q is None else q(mel), w.to(mel.dtype), up["b"].to(mel.dtype),
                               stride=cfg["upsample_stride"])[:, :, :t]
    b, c = spect.shape[0], spect.shape[1]
    g = cfg["groups"]
    return spect.reshape(b, c, t // g, g).permute(0, 1, 3, 2).reshape(b, c * g, t // g)


def _wn(p, cfg, x0, cond, q=None):
    ch = p["in_w"][0].shape[0] // 2
    h = _lin(x0, p["start_w"], p["start_b"], q)
    skip = 0.0
    n = cfg["wn_layers"]
    for i in range(n):
        w = p["in_w"][i] if q is None else q(p["in_w"][i])
        d = 2 ** i
        a = F.conv1d(h if q is None else q(h), w.to(h.dtype), p["in_b"][i].to(h.dtype),
                     padding=d * (w.shape[-1] - 1) // 2, dilation=d)
        a = a + _lin(cond, p["cond_w"][2 * ch * i : 2 * ch * (i + 1)],
                     p["cond_b"][2 * ch * i : 2 * ch * (i + 1)], q)
        acts = torch.tanh(a[:, :ch]) * torch.sigmoid(a[:, ch:])
        rs = _lin(acts, p["res_skip_w"][i], p["res_skip_b"][i], q)
        if i < n - 1:
            h = h + rs[:, :ch]
            skip = skip + rs[:, ch:]
        else:
            skip = skip + rs
    return _lin(skip, p["end_w"], p["end_b"], q)


def infer(params, cfg, mel, z, q=None, wn_only=False):
    """mel [B, n_mels, M], prior z [B, groups, blocks] -> audio [B, M * stride]."""
    q_wn = q
    if wn_only:
        q = None
    cond = condition(params, cfg, mel, q)
    b, blocks = z.shape[0], z.shape[2]
    if q is not None:
        z = q(z)
    early = [k for k in range(cfg["flows"]) if k % cfg["early_every"] == 0 and k > 0]
    chunks, off = {}, 0
    for k in early:
        chunks[k] = z[:, off : off + cfg["early_size"]]
        off += cfg["early_size"]
    x = z[:, off:]
    for k in reversed(range(cfg["flows"])):
        flow = params["flows"][k]
        half = x.shape[1] // 2
        x0, x1 = x[:, :half], x[:, half:]
        out = _wn(flow["wn"], cfg, x0, cond, q_wn)
        x1 = (x1 - out[:, :half]) * torch.exp(-out[:, half:])
        x = torch.cat([x0, x1], 1)
        w_inv = flow["convinv"]["w_inv"].to(x.dtype)
        if q is not None:
            x, w_inv = q(x), q(w_inv)
        x = torch.einsum("dc,bct->bdt", w_inv, x)
        if k in chunks:
            x = torch.cat([chunks[k], x], dim=1)
    return x.permute(0, 2, 1).reshape(b, blocks * cfg["groups"])
