# Copied from larynx_tpu/convert/torch_import.py; the package name in its imports differs and
# ``_stack`` walks the tree itself instead of through ``jax.tree.map``.
"""Convert reference PyTorch state dicts into larynx_tpu parameter pytrees.

Operates on plain ``{name: np.ndarray}`` dicts so the conversion logic is
independent of torch; :func:`load_torch_state_dict` handles the actual
``.pth`` deserialization (requires torch at call time only).

Layout conversions (torch -> ours, channels-last):
  * Conv1d weight [C_out, C_in, k]      -> [k, C_in, C_out]
  * 1x1 conv weight [C_out, C_in, 1]    -> matmul weight [C_in, C_out]
  * ConvTranspose1d weight [C_in, C_out, k] -> [k, C_in, C_out]
    (time flip happens inside ``nn.conv_transpose1d``)
  * weight-norm (weight_g, weight_v) pairs are folded into plain weights
    (semantics of remove_weight_norm, hifi_gan/models.py:204-211)
  * InvConvNear inverses are precomputed (store_inverse,
    glow_tts/layers.py:274-275)
  * the WN last-layer res_skip weight is zero-padded to uniform shape
    (see larynx_tpu.models.glow_tts.flows.wavenet)
"""

import typing
from pathlib import Path

import numpy as np

from larynx_tpu_torch.models.glow_tts.config import GlowTTSConfig

Array = np.ndarray
StateDict = typing.Dict[str, Array]


def load_torch_state_dict(
    path: typing.Union[str, Path], key: typing.Optional[str] = None
) -> StateDict:
    """Load a ``.pth`` checkpoint into numpy arrays.

    ``key`` picks the sub-dict ("model" for GlowTTS checkpoints,
    "generator" for HiFi-GAN ones); autodetected when None.
    """
    import torch

    ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and not any(
        hasattr(v, "numpy") for v in ckpt.values()
    ):
        if key is None:
            for candidate in ("model", "generator", "state_dict"):
                if candidate in ckpt:
                    key = candidate
                    break
        if key is not None and key in ckpt:
            ckpt = ckpt[key]
    if hasattr(ckpt, "state_dict"):  # a pickled whole nn.Module
        ckpt = ckpt.state_dict()
    out = {
        k: v.detach().cpu().float().numpy()
        for k, v in ckpt.items()
        if hasattr(v, "detach")
    }
    if not out:
        raise ValueError(
            f"{path}: no tensors found"
            + (
                f" (looked under key {key!r}; checkpoint has "
                f"{list(ckpt)[:8]})"
                if isinstance(ckpt, dict)
                else ""
            )
        )
    return out


# -----------------------------------------------------------------------------
# primitives


def _fold_wn(sd: StateDict, prefix: str) -> Array:
    """Fold weight-norm: w = g * v / ||v|| (norm over all axes but 0)."""
    v = sd[f"{prefix}.weight_v"]
    g = sd[f"{prefix}.weight_g"]
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt(np.sum(np.square(v), axis=axes, keepdims=True))
    return v * (g / norm)


def _weight(sd: StateDict, prefix: str) -> Array:
    if f"{prefix}.weight_v" in sd:
        return _fold_wn(sd, prefix)
    return sd[f"{prefix}.weight"]


def _conv(sd: StateDict, prefix: str) -> typing.Tuple[Array, Array]:
    """Conv1d -> ([k, C_in, C_out], [C_out])."""
    w = _weight(sd, prefix)
    return np.transpose(w, (2, 1, 0)), sd[f"{prefix}.bias"]


def _mat(sd: StateDict, prefix: str) -> typing.Tuple[Array, Array]:
    """1x1 Conv1d -> ([C_in, C_out], [C_out])."""
    w = _weight(sd, prefix)
    return np.transpose(w[:, :, 0]), sd[f"{prefix}.bias"]


def _ln(sd: StateDict, prefix: str) -> typing.Tuple[Array, Array]:
    return sd[f"{prefix}.gamma"], sd[f"{prefix}.beta"]


def _stack(trees: typing.Sequence) -> typing.Any:
    """Stack a list of same-structure pytrees along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return np.stack(trees)


# -----------------------------------------------------------------------------
# GlowTTS


def glow_tts_params_from_state_dict(
    sd: StateDict, cfg: GlowTTSConfig
) -> typing.Dict[str, typing.Any]:
    """Map the reference FlowGenerator state dict (glow_tts/models.py:216)
    into the pytree consumed by larynx_tpu.models.glow_tts."""
    encoder: typing.Dict[str, typing.Any] = {"emb": sd["encoder.emb.weight"]}

    if cfg.prenet:
        layers = []
        for i in range(3):
            w, b = _conv(sd, f"encoder.pre.conv_layers.{i}")
            g, beta = _ln(sd, f"encoder.pre.norm_layers.{i}")
            layers.append({"w": w, "b": b, "ln_g": g, "ln_b": beta})
        pw, pb = _mat(sd, "encoder.pre.proj")
        encoder["prenet"] = {"layers": layers, "proj_w": pw, "proj_b": pb}

    enc_layers = []
    for i in range(cfg.n_layers_enc):
        a = f"encoder.encoder.attn_layers.{i}"
        qw, qb = _mat(sd, f"{a}.conv_q")
        kw, kb = _mat(sd, f"{a}.conv_k")
        vw, vb = _mat(sd, f"{a}.conv_v")
        ow, ob = _mat(sd, f"{a}.conv_o")
        ln1g, ln1b = _ln(sd, f"encoder.encoder.norm_layers_1.{i}")
        c1w, c1b = _conv(sd, f"encoder.encoder.ffn_layers.{i}.conv_1")
        c2w, c2b = _conv(sd, f"encoder.encoder.ffn_layers.{i}.conv_2")
        ln2g, ln2b = _ln(sd, f"encoder.encoder.norm_layers_2.{i}")
        layer = {
            "q_w": qw, "q_b": qb, "k_w": kw, "k_b": kb,
            "v_w": vw, "v_b": vb, "o_w": ow, "o_b": ob,
            "ln1_g": ln1g, "ln1_b": ln1b,
            "conv1_w": c1w, "conv1_b": c1b,
            "conv2_w": c2w, "conv2_b": c2b,
            "ln2_g": ln2g, "ln2_b": ln2b,
        }
        if cfg.window_size is not None:
            # [n_heads_rel=1, 2w+1, dk] -> [2w+1, dk] (heads shared)
            layer["emb_rel_k"] = sd[f"{a}.emb_rel_k"][0]
            layer["emb_rel_v"] = sd[f"{a}.emb_rel_v"][0]
        enc_layers.append(layer)
    encoder["layers"] = _stack(enc_layers)

    pmw, pmb = _mat(sd, "encoder.proj_m")
    encoder["proj_m_w"], encoder["proj_m_b"] = pmw, pmb
    if not cfg.mean_only:
        psw, psb = _mat(sd, "encoder.proj_s")
        encoder["proj_s_w"], encoder["proj_s_b"] = psw, psb

    d1w, d1b = _conv(sd, "encoder.proj_w.conv_1")
    d2w, d2b = _conv(sd, "encoder.proj_w.conv_2")
    dpw, dpb = _mat(sd, "encoder.proj_w.proj")
    n1g, n1b = _ln(sd, "encoder.proj_w.norm_1")
    n2g, n2b = _ln(sd, "encoder.proj_w.norm_2")
    encoder["dp"] = {
        "conv1_w": d1w, "conv1_b": d1b, "ln1_g": n1g, "ln1_b": n1b,
        "conv2_w": d2w, "conv2_b": d2b, "ln2_g": n2g, "ln2_b": n2b,
        "proj_w": dpw, "proj_b": dpb,
    }

    # Decoder: flows are interleaved [actnorm, invconv, coupling] x n_blocks
    hd = cfg.dec_channels
    blocks = []
    for b_idx in range(cfg.n_blocks_dec):
        base = b_idx * 3
        an = f"decoder.flows.{base}"
        actnorm = {
            "logs": sd[f"{an}.logs"].reshape(-1),
            "bias": sd[f"{an}.bias"].reshape(-1),
        }
        weight = sd[f"decoder.flows.{base + 1}.weight"]
        invconv = {
            "weight": weight,
            "weight_inv": np.linalg.inv(weight.astype(np.float64)).astype(
                weight.dtype
            ),
        }
        cp = f"decoder.flows.{base + 2}"
        sw, sb = _mat(sd, f"{cp}.start")
        ew, eb = _mat(sd, f"{cp}.end")
        in_w, in_b, rs_w, rs_b = [], [], [], []
        for i in range(cfg.n_block_layers):
            w, bias = _conv(sd, f"{cp}.wn.in_layers.{i}")
            in_w.append(w)
            in_b.append(bias)
            w, bias = _mat(sd, f"{cp}.wn.res_skip_layers.{i}")
            if i == cfg.n_block_layers - 1:
                # last layer: skip-only -> zero-pad the res half
                w = np.concatenate([np.zeros((hd, hd), w.dtype), w], axis=-1)
                bias = np.concatenate([np.zeros(hd, bias.dtype), bias])
            rs_w.append(w)
            rs_b.append(bias)
        coupling = {
            "start_w": sw, "start_b": sb, "end_w": ew, "end_b": eb,
            "wn": {
                "in_w": np.stack(in_w), "in_b": np.stack(in_b),
                "res_skip_w": np.stack(rs_w), "res_skip_b": np.stack(rs_b),
            },
        }
        if cfg.gin_channels > 0:
            cw, cb = _conv(sd, f"{cp}.wn.cond_layer")
            coupling["wn"]["cond_w"] = cw
            coupling["wn"]["cond_b"] = cb
        blocks.append(
            {"actnorm": actnorm, "invconv": invconv, "coupling": coupling}
        )

    params: typing.Dict[str, typing.Any] = {
        "encoder": encoder,
        "decoder": _stack(blocks),
    }
    if cfg.n_speakers > 1:
        params["emb_g"] = sd["emb_g.weight"]
    return params


# -----------------------------------------------------------------------------
# HiFi-GAN


def hifi_gan_params_from_state_dict(
    sd: StateDict,
    upsample_rates: typing.Sequence[int],
    resblock_kernel_sizes: typing.Sequence[int],
    resblock: str = "1",
) -> typing.Dict[str, typing.Any]:
    """Map the reference HiFi-GAN Generator state dict
    (hifi_gan/models.py:148-211) into our pytree."""
    params: typing.Dict[str, typing.Any] = {}
    w, b = _conv(sd, "conv_pre")
    params["conv_pre"] = {"w": w, "b": b}

    ups = []
    for i in range(len(upsample_rates)):
        wt = _weight(sd, f"ups.{i}")  # [C_in, C_out, k]
        ups.append(
            {
                "w": np.transpose(wt, (2, 0, 1)),  # [k, C_in, C_out]
                "b": sd[f"ups.{i}.bias"],
            }
        )
    params["ups"] = ups

    n_kernels = len(resblock_kernel_sizes)
    resblocks = []
    for i in range(len(upsample_rates) * n_kernels):
        prefix = f"resblocks.{i}"
        if resblock == "1":
            block = {
                "convs1": [_conv_pair(sd, f"{prefix}.convs1.{j}") for j in range(3)],
                "convs2": [_conv_pair(sd, f"{prefix}.convs2.{j}") for j in range(3)],
            }
        else:
            block = {
                "convs": [_conv_pair(sd, f"{prefix}.convs.{j}") for j in range(2)]
            }
        resblocks.append(block)
    params["resblocks"] = resblocks

    w, b = _conv(sd, "conv_post")
    params["conv_post"] = {"w": w, "b": b}
    return params


def _conv_pair(sd: StateDict, prefix: str) -> typing.Dict[str, Array]:
    w, b = _conv(sd, prefix)
    return {"w": w, "b": b}


# -----------------------------------------------------------------------------
# WaveGlow (NVIDIA checkpoint naming; the reference ships the config at
# local/waveglow/wn_256 but no loader — larynx/__init__.py:498-508)


def waveglow_params_from_state_dict(
    sd: StateDict, cfg
) -> typing.Dict[str, typing.Any]:
    """Map an NVIDIA WaveGlow state dict into our pytree.

    Weight norm is folded; the invertible 1x1 convs get their inverses
    precomputed.  Supports both the fused ``cond_layer`` (the released
    "amp" checkpoints) and the older per-layer ``cond_layers.{i}``.
    """
    wt = _weight(sd, "upsample")  # ConvTranspose1d [C_in, C_out, k]
    params: typing.Dict[str, typing.Any] = {
        "upsample": {
            "w": np.transpose(wt, (2, 0, 1)),
            "b": sd["upsample.bias"],
        },
        "flows": [],
    }

    ch = cfg.wn_channels
    for k in range(cfg.flows):
        w_conv = sd[f"convinv.{k}.conv.weight"][:, :, 0]  # [c_out, c_in]
        wn_prefix = f"WN.{k}"
        start_w, start_b = _mat(sd, f"{wn_prefix}.start")

        if f"{wn_prefix}.cond_layer.weight_v" in sd or (
            f"{wn_prefix}.cond_layer.weight" in sd
        ):
            cond_w, cond_b = _mat(sd, f"{wn_prefix}.cond_layer")
        else:
            # older layout: one cond conv per WN layer, outputs 2*ch each
            ws, bs = [], []
            for i in range(cfg.wn_layers):
                wi, bi = _mat(sd, f"{wn_prefix}.cond_layers.{i}")
                ws.append(wi)
                bs.append(bi)
            cond_w = np.concatenate(ws, axis=1)
            cond_b = np.concatenate(bs)

        in_w, in_b, rs_w, rs_b = [], [], [], []
        for i in range(cfg.wn_layers):
            wi, bi = _conv(sd, f"{wn_prefix}.in_layers.{i}")
            in_w.append(wi)
            in_b.append(bi)
            wr, br = _mat(sd, f"{wn_prefix}.res_skip_layers.{i}")
            rs_w.append(wr)
            rs_b.append(br)

        end_w, end_b = _mat(sd, f"{wn_prefix}.end")
        got_ch = in_w[0].shape[2] // 2
        if got_ch != ch:
            raise ValueError(
                f"checkpoint wn_channels={got_ch} != config "
                f"wn_channels={ch} (flow {k})"
            )
        params["flows"].append(
            {
                "convinv": {
                    "w": w_conv,
                    "w_inv": np.linalg.inv(w_conv),
                },
                "wn": {
                    "start_w": start_w,
                    "start_b": start_b,
                    "cond_w": cond_w,
                    "cond_b": cond_b,
                    "in_w": in_w,
                    "in_b": in_b,
                    "res_skip_w": rs_w,
                    "res_skip_b": rs_b,
                    "end_w": end_w,
                    "end_b": end_b,
                },
            }
        )
    return params


# -----------------------------------------------------------------------------
# Tacotron2 (NVIDIA checkpoint naming; the reference declares the family —
# larynx/constants.py:22 — but has no loader: larynx/__init__.py:379-407)


def _linear(sd: StateDict, prefix: str) -> typing.Dict[str, Array]:
    """torch Linear [out, in] -> {"w": [in, out], "b"?: [out]}."""
    p: typing.Dict[str, Array] = {"w": np.transpose(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"]
    return p


def _lstm(sd: StateDict, prefix: str, suffix: str = "") -> typing.Dict[str, Array]:
    """torch LSTM(Cell) gates [4H, in] -> fused {"w_ih","w_hh","b"}."""
    return {
        "w_ih": np.transpose(sd[f"{prefix}.weight_ih{suffix}"]),
        "w_hh": np.transpose(sd[f"{prefix}.weight_hh{suffix}"]),
        "b": sd[f"{prefix}.bias_ih{suffix}"] + sd[f"{prefix}.bias_hh{suffix}"],
    }


def _conv_bn(sd: StateDict, prefix: str) -> typing.Dict[str, typing.Any]:
    """NVIDIA ConvNorm+BatchNorm1d pair (Sequential indices .0/.1)."""
    w, b = _conv(sd, f"{prefix}.0.conv")
    return {
        "w": w,
        "b": b,
        "bn": {
            "gamma": sd[f"{prefix}.1.weight"],
            "beta": sd[f"{prefix}.1.bias"],
            "mean": sd[f"{prefix}.1.running_mean"],
            "var": sd[f"{prefix}.1.running_var"],
        },
    }


def tacotron2_params_from_state_dict(
    sd: StateDict, cfg
) -> typing.Dict[str, typing.Any]:
    """Map an NVIDIA Tacotron2 state dict into our pytree.

    Linear/LSTM weights transpose to channels-last; LSTM bias pairs fuse
    (the cell adds one bias); BatchNorm running stats come along for
    inference-mode normalization.
    """
    att_prefix = "decoder.attention_layer"
    params: typing.Dict[str, typing.Any] = {
        "embedding": sd["embedding.weight"],
        "encoder": {
            "convs": [
                _conv_bn(sd, f"encoder.convolutions.{i}")
                for i in range(cfg.encoder_n_convolutions)
            ],
            "lstm_fw": _lstm(sd, "encoder.lstm", "_l0"),
            "lstm_bw": _lstm(sd, "encoder.lstm", "_l0_reverse"),
        },
        "decoder": {
            "prenet": [
                _linear(sd, f"decoder.prenet.layers.{i}.linear_layer")
                for i in range(2)
            ],
            "attention_rnn": _lstm(sd, "decoder.attention_rnn"),
            "attention": {
                "query": _linear(sd, f"{att_prefix}.query_layer.linear_layer"),
                "memory": _linear(
                    sd, f"{att_prefix}.memory_layer.linear_layer"
                ),
                "v": _linear(sd, f"{att_prefix}.v.linear_layer"),
                "location_conv": np.transpose(
                    sd[f"{att_prefix}.location_layer.location_conv.conv.weight"],
                    (2, 1, 0),
                ),
                "location_dense": _linear(
                    sd, f"{att_prefix}.location_layer.location_dense.linear_layer"
                ),
            },
            "decoder_rnn": _lstm(sd, "decoder.decoder_rnn"),
            "projection": _linear(sd, "decoder.linear_projection.linear_layer"),
            "gate": _linear(sd, "decoder.gate_layer.linear_layer"),
        },
        "postnet": {
            "convs": [
                _conv_bn(sd, f"postnet.convolutions.{i}")
                for i in range(cfg.postnet_n_convolutions)
            ]
        },
    }
    emb_symbols = params["embedding"].shape[0]
    if emb_symbols != cfg.num_symbols:
        raise ValueError(
            f"checkpoint num_symbols={emb_symbols} != config "
            f"num_symbols={cfg.num_symbols}"
        )
    return params
