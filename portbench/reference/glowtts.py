"""GlowTTS inference in plain PyTorch: the text encoder with its windowed
relative-position attention, the duration predictor, the duration rule and
the reverse flow (ActNorm, grouped invertible 1x1, affine coupling with a
WaveNet), written from the GlowTTS paper and its published code
(github.com/jaywalnut310/glow-tts, ``models.py``, ``attentions.py``,
``modules.py``).

Tensors are channels-first ([B, C, T]) inside, as in the published code.
Parameters come as a tree in PyTorch's layout (convs [C_out, C_in, k],
1x1 projections [C_out, C_in], per-layer tensors stacked on axis 0), the
tree that the benchmark draws and hands to both sides.  Every function
computes in the dtype of its inputs (float64 for the reference, float32
for the lower-precision control).
"""

import math

import torch
import torch.nn.functional as F

ATTN_MASK_VALUE = -1e4  # the published attention masks with masked_fill(-1e4)
LN_EPS = 1e-4


def _ln(x, g, b):
    """LayerNorm over channels of [B, C, T]."""
    mean = x.mean(dim=1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * g[None, :, None] + b[None, :, None]


def _conv(x, w, b, dilation=1):
    k = w.shape[-1]
    return F.conv1d(x, w, b, padding=dilation * (k - 1) // 2, dilation=dilation)


def _lin(x, w, b=None):
    """1x1 conv of [B, C_in, T] by w [C_out, C_in]."""
    y = torch.einsum("oc,bct->bot", w, x)
    return y if b is None else y + b[None, :, None]


def _attention(p, x, mask, n_heads, window):
    """Multi-head self-attention with relative keys and values inside
    +-window: score(i, j) = q_i . (k_j + e_k[j - i]) / sqrt(d), and
    out_i = sum_j p_ij (v_j + e_v[j - i]); offsets outside the window carry
    no embedding."""
    b, c, t = x.shape
    d = c // n_heads
    q = _lin(x, p["q_w"], p["q_b"]).reshape(b, n_heads, d, t)
    k = _lin(x, p["k_w"], p["k_b"]).reshape(b, n_heads, d, t)
    v = _lin(x, p["v_w"], p["v_b"]).reshape(b, n_heads, d, t)
    scores = torch.einsum("bhdi,bhdj->bhij", q, k)
    pos = torch.arange(t, device=x.device)
    offset = pos[None, :] - pos[:, None]  # [i, j] -> j - i
    inside = offset.abs() <= window
    idx = (offset.clamp(-window, window) + window)  # [T, T]
    rel_k = p["emb_rel_k"][idx] * inside[..., None]  # [T, T, d]
    rel_v = p["emb_rel_v"][idx] * inside[..., None]
    scores = (scores + torch.einsum("bhdi,ijd->bhij", q, rel_k)) / math.sqrt(d)
    valid = (mask[:, 0, :, None] > 0) & (mask[:, 0, None, :] > 0)
    scores = scores.masked_fill(~valid[:, None], ATTN_MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhij,bhdj->bhdi", probs, v) + torch.einsum("bhij,ijd->bhdi", probs, rel_v)
    return _lin(out.reshape(b, c, t), p["o_w"], p["o_b"])


def encode(params, cfg, ids, lengths, length_scale):
    """ids [B, T] (int64), lengths [B] -> dict of x_m [B, C_mel, T], logw
    [B, T], w [B, T] (the durations before the ceiling), w_ceil, y_lengths
    [B] (int64) and the text mask [B, 1, T]."""
    p = params["encoder"]
    dtype = p["emb"].dtype
    t = ids.shape[1]
    h = cfg["hidden_channels"]
    mask = (torch.arange(t, device=ids.device)[None, :] < lengths[:, None]).to(dtype)[:, None]
    x = (p["emb"][ids] * math.sqrt(h)).transpose(1, 2)  # [B, h, T]
    if cfg.get("prenet", False):
        y = x
        for layer in p["prenet"]["layers"]:
            y = _ln(_conv(y * mask, layer["w"], layer["b"]), layer["ln_g"], layer["ln_b"])
            y = torch.relu(y)
        x = (x + _lin(y, p["prenet"]["proj_w"], p["prenet"]["proj_b"])) * mask
    stacked = p["layers"]
    for i in range(cfg["n_layers_enc"]):
        lp = {name: value[i] for name, value in stacked.items()}
        x = x * mask
        y = _attention(lp, x, mask, cfg["n_heads"], cfg["window_size"])
        x = _ln(x + y, lp["ln1_g"], lp["ln1_b"])
        y = torch.relu(_conv(x * mask, lp["conv1_w"], lp["conv1_b"]))
        y = _conv(y * mask, lp["conv2_w"], lp["conv2_b"]) * mask
        x = _ln(x + y, lp["ln2_g"], lp["ln2_b"])
    x = x * mask
    x_m = _lin(x, p["proj_m_w"], p["proj_m_b"]) * mask
    dp = p["dp"]
    y = _ln(torch.relu(_conv(x * mask, dp["conv1_w"], dp["conv1_b"])), dp["ln1_g"], dp["ln1_b"])
    y = _ln(torch.relu(_conv(y * mask, dp["conv2_w"], dp["conv2_b"])), dp["ln2_g"], dp["ln2_b"])
    logw = (_lin(y * mask, dp["proj_w"], dp["proj_b"]) * mask)[:, 0]
    w = torch.exp(logw) * mask[:, 0] * length_scale
    w_ceil = torch.ceil(w)
    n_sqz = cfg["n_sqz"]
    y_lengths = torch.clamp(w_ceil.sum(dim=1), min=1).long() // n_sqz * n_sqz
    y_lengths = torch.clamp(y_lengths, min=n_sqz)
    return {"x_m": x_m, "logw": logw, "w": w, "w_ceil": w_ceil, "y_lengths": y_lengths,
            "mask": mask}


def expand(x_m, w_ceil, m):
    """Each of the m frames takes the mean of its token: frame f belongs to
    the first token whose cumulative duration exceeds f; frames past the
    total duration take zeros.  -> [B, C, m]."""
    b, c, t = x_m.shape
    cum = torch.cumsum(w_ceil, dim=1)  # [B, T]
    frames = torch.arange(m, device=x_m.device, dtype=cum.dtype)
    token = (cum[:, :, None] <= frames[None, None, :]).sum(dim=1)  # [B, m]
    inside = token < t
    gathered = torch.gather(x_m, 2, token.clamp(max=t - 1)[:, None, :].expand(b, c, m))
    return gathered * inside[:, None, :].to(x_m.dtype)


def _wavenet(p, x, mask, n_layers, hidden):
    out = torch.zeros_like(x)
    for i in range(n_layers):
        a = _conv(x, p["in_w"][i], p["in_b"][i])
        acts = torch.tanh(a[:, :hidden]) * torch.sigmoid(a[:, hidden:])
        rs = _lin(acts, p["res_skip_w"][i], p["res_skip_b"][i])
        if i < n_layers - 1:
            x = (x + rs[:, :hidden]) * mask
        out = out + rs[:, hidden:]
    return out * mask


def decode(params, cfg, z, y_mask):
    """The reverse flow: latent z [B, C, M] (M even), mask [B, 1, M] ->
    mel [B, C, M].  Blocks run last to first: coupling, invertible 1x1,
    ActNorm, each inverted, on the time-squeezed [B, 2C, M/2] latent."""
    b, c, m = z.shape
    n_sqz, n_split, hidden = cfg["n_sqz"], cfg["n_split"], cfg["hidden_channels"]
    # squeeze: channel s * C + ch holds frame n_sqz * t + s
    x = z.reshape(b, c, m // n_sqz, n_sqz).permute(0, 3, 1, 2).reshape(b, c * n_sqz, m // n_sqz)
    mask = y_mask[:, :, n_sqz - 1 :: n_sqz]
    x = x * mask
    dec = params["decoder"]
    cs = c * n_sqz
    for blk in reversed(range(cfg["n_blocks_dec"])):
        cp = {k: v[blk] for k, v in dec["coupling"].items() if k != "wn"}
        wn = {k: v[blk] for k, v in dec["coupling"]["wn"].items()}
        x0, x1 = x[:, : cs // 2], x[:, cs // 2 :]
        h = _lin(x0, cp["start_w"], cp["start_b"]) * mask
        h = _wavenet(wn, h, mask, cfg["n_block_layers"], hidden)
        out = _lin(h, cp["end_w"], cp["end_b"])
        mean, logs = out[:, : cs // 2], out[:, cs // 2 :]
        x = torch.cat([x0, (x1 - mean) * torch.exp(-logs) * mask], dim=1)
        # invertible 1x1 over n_split channel groups: channel
        # a * cs/2 + k * n_split/2 + d belongs to group a * n_split/2 + d
        w_inv = dec["invconv"]["weight_inv"][blk].to(x.dtype)
        g = x.reshape(b, 2, cs // n_split, n_split // 2, -1).permute(0, 1, 3, 2, 4)
        g = g.reshape(b, n_split, cs // n_split, -1)
        g = torch.einsum("st,btkx->bskx", w_inv, g)
        g = g.reshape(b, 2, n_split // 2, cs // n_split, -1).permute(0, 1, 3, 2, 4)
        x = g.reshape(b, cs, -1) * mask
        an = dec["actnorm"]
        x = (x - an["bias"][blk][None, :, None]) * torch.exp(-an["logs"][blk])[None, :, None] * mask
    x = x.reshape(b, n_sqz, c, m // n_sqz).permute(0, 2, 3, 1).reshape(b, c, m)
    return x * y_mask
