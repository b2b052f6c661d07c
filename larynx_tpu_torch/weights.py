"""Parameters: the native (.npz) layout to the port's tensors, and random init.

The native checkpoint layout is the JAX package's parameter tree
(``convert/native.py``): convs ``[k, C_in, C_out]``, transposed convs
``[k, C_in, C_out]`` (correlation form), 1x1 projections ``[C_in, C_out]``,
with per-layer / per-block params stacked on leading axes (WaveGlow keeps
its per-layer params as lists).  :func:`params_from_jax` transposes once,
at load, to PyTorch's layout: convs ``[C_out, C_in, k]``, transposed convs
``[C_in, C_out, k]`` and 1x1 projections ``[C_out, C_in]`` (leading stack
axes are kept; a multi-speaker voice's coupling ``cond_w`` [1, gin, 2h * L]
becomes [1, 2h * L, gin] and its ``emb_g`` [n_speakers, gin] stays).
WaveGlow's invertible 1x1s (``convinv.w``/``w_inv``) are already
``[C_out, C_in]`` in the native layout and stay as they are.  Tacotron2's
linears and LSTM gates ``[in, out]`` become ``[out, in]`` (the fused LSTM
bias ``b`` stays), its convs, ``location_conv`` ``[k, 2, F]`` among them,
``[C_out, C_in, k]``; its embedding and BatchNorm vectors stay.  HiFi-GAN's
discriminators (training only) take their period convs ``[kh, kw, C_in,
C_out]`` to ``[C_out, C_in, kh, kw]`` and their scale convs as convs.
:func:`params_to_jax` writes the port's tensors of every kind back in the
native layout, as the trainers save them.

:func:`init_params` draws a random native tree with the JAX package's
shapes and distributions from a ``torch.Generator``, so a machine without
JAX can stage a voice directory.
"""

import math
import threading
import typing

import numpy as np
import torch

from larynx_tpu_torch.models.glow_tts.config import GlowTTSConfig
from larynx_tpu_torch.models.hifi_gan.config import HiFiGanConfig
from larynx_tpu_torch.models.tacotron2.config import Tacotron2Config
from larynx_tpu_torch.models.waveglow.config import WaveGlowConfig

Params = typing.Dict[str, typing.Any]

_CONV_KEYS = {"w", "conv1_w", "conv2_w", "in_w"}
_MAT_KEYS = {
    "q_w", "k_w", "v_w", "o_w", "proj_w", "proj_m_w", "proj_s_w",
    "start_w", "end_w", "res_skip_w", "cond_w",
}
_WAVEGLOW_MAT_KEYS = {"start_w", "cond_w", "res_skip_w", "end_w"}


def _convert_waveglow(path: typing.Tuple[str, ...], arr: np.ndarray,
                      inverse: bool) -> np.ndarray:
    """upsample.w [k, Ci, Co] <-> [Ci, Co, k]; each WN layer's in_w [k, Ci, Co]
    -> [Co, Ci, k]; the WN's 1x1s [Ci, Co] -> [Co, Ci], so cond_w
    [cc, 2ch*L] becomes [2ch*L, cc] and layer i reads its rows
    [2ch*i, 2ch*(i+1)); convinv.w / w_inv unchanged."""
    key = next(p for p in reversed(path) if not p.isdigit())  # past list indices
    if path[0] == "upsample" and key == "w":
        return np.moveaxis(arr, -1, -3) if inverse else np.moveaxis(arr, -3, -1)
    if key == "in_w":
        return np.swapaxes(arr, -3, -1)
    if key in _WAVEGLOW_MAT_KEYS:
        return np.swapaxes(arr, -2, -1)
    return arr


def _convert_tacotron2(path: typing.Tuple[str, ...], arr: np.ndarray) -> np.ndarray:
    """Convs (``w`` [k, Ci, Co], ``location_conv`` [k, 2, F]) -> [Co, Ci, k];
    linears and LSTM gates [in, out] -> [out, in]."""
    key = path[-1]
    if key == "location_conv" or (key == "w" and arr.ndim == 3):
        return np.swapaxes(arr, -3, -1)
    if key in ("w", "w_ih", "w_hh"):
        return np.swapaxes(arr, -2, -1)
    return arr


def _convert_discriminators(path: typing.Tuple[str, ...], arr: np.ndarray,
                            inverse: bool) -> np.ndarray:
    """MPD conv2d ``w`` [kh, kw, Ci, Co] <-> [Co, Ci, kh, kw]; MSD (grouped)
    conv1d ``w`` [k, Ci/g, Co] <-> [Co, Ci/g, k]."""
    if path[-1] != "w":
        return arr
    if arr.ndim == 4:
        return arr.transpose((2, 3, 1, 0) if inverse else (3, 2, 0, 1))
    return np.swapaxes(arr, -3, -1)


def _convert(path: typing.Tuple[str, ...], arr: np.ndarray, kind: str,
             inverse: bool = False) -> np.ndarray:
    """One leaf from the native layout to the port's, or back (``inverse``;
    every other conversion is its own inverse)."""
    if kind == "waveglow":
        return _convert_waveglow(path, arr, inverse)
    if kind == "tacotron2":
        return _convert_tacotron2(path, arr)
    if kind == "discriminators":
        return _convert_discriminators(path, arr, inverse)
    key = path[-1]
    if kind == "hifi_gan" and path[0] == "ups" and key == "w":
        # [k, Ci, Co] <-> [Ci, Co, k]
        return np.moveaxis(arr, -1, -3) if inverse else np.moveaxis(arr, -3, -1)
    if key in _CONV_KEYS:
        return np.swapaxes(arr, -3, -1)  # [..., k, Ci, Co] <-> [..., Co, Ci, k]
    if kind == "glow_tts" and key in _MAT_KEYS:
        return np.swapaxes(arr, -2, -1)  # [..., Ci, Co] <-> [..., Co, Ci]
    return arr


def params_from_jax(tree: Params, kind: str, device=None) -> Params:
    """Native parameter tree (numpy) -> the port's tensors.

    ``kind`` is ``"glow_tts"``, ``"hifi_gan"``, ``"waveglow"``,
    ``"tacotron2"`` or ``"discriminators"`` (HiFi-GAN's, for training).
    Floating leaves become float32; integer leaves keep their type.
    """
    if kind not in ("glow_tts", "hifi_gan", "waveglow", "tacotron2", "discriminators"):
        raise ValueError(f"unknown parameter kind {kind!r}")

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
        arr = _convert(path, np.asarray(node), kind)
        if np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    return walk(tree, ())


def params_to_jax(tree: Params, kind: str) -> Params:
    """The port's tensors -> a native (numpy, float32) tree, the inverse of
    :func:`params_from_jax` for every ``kind``: what the trainers save as
    ``generator.npz``."""
    if kind not in ("glow_tts", "hifi_gan", "waveglow", "tacotron2", "discriminators"):
        raise ValueError(f"unknown parameter kind {kind!r}")

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
        arr = _convert(path, node.detach().cpu().numpy(), kind, inverse=True)
        if np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(np.float32)
        return np.ascontiguousarray(arr)

    return walk(tree, ())


# The GlowTTS encoder layers' tensor-parallel split, in the port's layout
# (stacked layers on axis 0): conv1 [L, f, h, k] and q/k/v [L, h_out, h_in]
# on their outputs, conv2 [L, h, f, k] and o [L, h_out, h_in] on their inputs
# (``larynx_tpu/parallel/mesh.py::glow_param_specs`` in the native layout).
GLOW_TP_AXES = {
    "conv1_w": 1, "conv1_b": 1, "conv2_w": 2,
    "q_w": 1, "k_w": 1, "v_w": 1, "q_b": 1, "k_b": 1, "v_b": 1, "o_w": 2,
}


def glow_tp_axis(path: typing.Tuple[str, ...]) -> typing.Optional[int]:
    """The axis of a GlowTTS leaf (by its key path) that the model ranks
    split, or None for a replicated leaf."""
    return GLOW_TP_AXES.get(path[-1]) if path[:2] == ("encoder", "layers") else None


def tp_slice(params: Params, n: int, k: int, path: typing.Tuple[str, ...] = ()) -> Params:
    """Model rank k's slice (of n) of a GlowTTS tree in the port's layout:
    each split leaf's k-th contiguous chunk, every other leaf as it is."""
    if isinstance(params, dict):
        return {key: tp_slice(v, n, k, path + (key,)) for key, v in params.items()}
    if isinstance(params, list):
        return [tp_slice(v, n, k, path + (str(i),)) for i, v in enumerate(params)]
    axis = glow_tp_axis(path)
    return params if axis is None else torch.chunk(params, n, dim=axis)[k].contiguous()


def tp_merge(shards: typing.Sequence[Params], path: typing.Tuple[str, ...] = ()) -> Params:
    """The full GlowTTS tree from every model rank's slice, in rank order:
    the inverse of :func:`tp_slice` (replicated leaves from rank 0)."""
    first = shards[0]
    if isinstance(first, dict):
        return {key: tp_merge([s[key] for s in shards], path + (key,)) for key in first}
    if isinstance(first, list):
        return [tp_merge([s[i] for s in shards], path + (str(i),)) for i in range(len(first))]
    axis = glow_tp_axis(path)
    return first if axis is None else torch.cat(list(shards), dim=axis)


def tree_to(tree, device) -> typing.Any:
    """Move every tensor of a parameter tree to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


class PerDevice:
    """What a model keeps per (device, dtype), such as its packed params:
    built by ``build(device, dtype)`` once per key, under a lock, since
    threads that share the model (the server's workers) may ask for it at
    once."""

    def __init__(self, build: typing.Callable[[torch.device, torch.dtype], typing.Any]):
        self._build = build
        self._items: typing.Dict[typing.Tuple[str, torch.dtype], typing.Any] = {}
        self._lock = threading.Lock()

    def get(self, device: torch.device, dtype: torch.dtype) -> typing.Any:
        key = (str(device), dtype)
        item = self._items.get(key)
        if item is None:
            with self._lock:
                item = self._items.get(key)
                if item is None:
                    item = self._items[key] = self._build(device, dtype)
        return item


def cast(tree, dtype: torch.dtype) -> typing.Any:
    """A parameter tree with its floating tensors in ``dtype`` and its
    integer tensors as they are, as the JAX engine casts its params for a
    precision (``larynx_tpu/runtime/engine.py:299-313``)."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


# -----------------------------------------------------------------------------
# Random init in the native layout


def _uniform(gen, shape, bound) -> np.ndarray:
    return ((torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound).numpy()


def _normal(gen, shape, std=1.0) -> np.ndarray:
    return (torch.randn(shape, generator=gen) * std).numpy()


def _xavier(gen, shape, fan_in, fan_out) -> np.ndarray:
    return _uniform(gen, shape, math.sqrt(6.0 / (fan_in + fan_out)))


def _conv_init(gen, k, c_in, c_out):
    bound = 1.0 / math.sqrt(c_in * k)
    return _uniform(gen, (k, c_in, c_out), bound), _uniform(gen, (c_out,), bound)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _init_glow_tts(gen: torch.Generator, cfg: GlowTTSConfig) -> Params:
    h, dk = cfg.enc_channels, cfg.k_channels
    zeros, ones = np.zeros, np.ones
    encoder: Params = {"emb": _normal(gen, (cfg.num_symbols, h), h**-0.5)}
    if cfg.prenet:
        layers = []
        for _ in range(3):
            w, b = _conv_init(gen, 5, h, h)
            layers.append({"w": w, "b": b, "ln_g": ones(h), "ln_b": zeros(h)})
        encoder["prenet"] = {"layers": layers, "proj_w": zeros((h, h)), "proj_b": zeros(h)}

    enc_layers = []
    for _ in range(cfg.n_layers_enc):
        conv1_w, conv1_b = _conv_init(gen, cfg.kernel_size, h, cfg.filter_channels)
        conv2_w, conv2_b = _conv_init(gen, cfg.kernel_size, cfg.filter_channels, h)
        layer = {}
        for name in ("q", "k", "v", "o"):
            layer[f"{name}_w"] = _xavier(gen, (h, h), h, h)
            layer[f"{name}_b"] = zeros(h)
        layer.update(
            ln1_g=ones(h), ln1_b=zeros(h), conv1_w=conv1_w, conv1_b=conv1_b,
            conv2_w=conv2_w, conv2_b=conv2_b, ln2_g=ones(h), ln2_b=zeros(h),
        )
        if cfg.window_size is not None:
            layer["emb_rel_k"] = _normal(gen, (2 * cfg.window_size + 1, dk), dk**-0.5)
            layer["emb_rel_v"] = _normal(gen, (2 * cfg.window_size + 1, dk), dk**-0.5)
        enc_layers.append(layer)
    encoder["layers"] = _stack(enc_layers)

    encoder["proj_m_w"] = _xavier(gen, (h, cfg.mel_channels), h, cfg.mel_channels)
    encoder["proj_m_b"] = zeros(cfg.mel_channels)
    if not cfg.mean_only:
        encoder["proj_s_w"] = _xavier(gen, (h, cfg.mel_channels), h, cfg.mel_channels)
        encoder["proj_s_b"] = zeros(cfg.mel_channels)

    fdp = cfg.filter_channels_dp
    dp_conv1_w, dp_conv1_b = _conv_init(gen, cfg.kernel_size, h + cfg.gin_channels, fdp)
    dp_conv2_w, dp_conv2_b = _conv_init(gen, cfg.kernel_size, fdp, fdp)
    encoder["dp"] = {
        "conv1_w": dp_conv1_w, "conv1_b": dp_conv1_b, "ln1_g": ones(fdp), "ln1_b": zeros(fdp),
        "conv2_w": dp_conv2_w, "conv2_b": dp_conv2_b, "ln2_g": ones(fdp), "ln2_b": zeros(fdp),
        "proj_w": _xavier(gen, (fdp, 1), fdp, 1), "proj_b": zeros(1),
    }

    c_sqz, hd = cfg.sqz_channels, cfg.dec_channels
    blocks = []
    for _ in range(cfg.n_blocks_dec):
        q = np.linalg.qr(_normal(gen, (cfg.n_split, cfg.n_split)).astype(np.float64))[0]
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        in_w, in_b, rs_w, rs_b = [], [], [], []
        for i in range(cfg.n_block_layers):
            w, b = _conv_init(gen, cfg.kernel_size_dec, hd, 2 * hd)
            in_w.append(w)
            in_b.append(b)
            if i < cfg.n_block_layers - 1:
                w, b = _conv_init(gen, 1, hd, 2 * hd)
                rs_w.append(w[0])
                rs_b.append(b)
            else:  # last layer emits skip only: zero-pad the res half
                w, b = _conv_init(gen, 1, hd, hd)
                rs_w.append(np.concatenate([zeros((hd, hd)), w[0]], axis=-1))
                rs_b.append(np.concatenate([zeros(hd), b]))
        start_w, start_b = _conv_init(gen, 1, c_sqz // 2, hd)
        wn = {
            "in_w": np.stack(in_w), "in_b": np.stack(in_b),
            "res_skip_w": np.stack(rs_w), "res_skip_b": np.stack(rs_b),
        }
        if cfg.n_speakers > 1 and cfg.gin_channels > 0:  # speaker conditioning 1x1
            wn["cond_w"], wn["cond_b"] = _conv_init(
                gen, 1, cfg.gin_channels, 2 * hd * cfg.n_block_layers
            )
        blocks.append({
            "actnorm": {"logs": zeros(c_sqz), "bias": zeros(c_sqz)},
            "invconv": {"weight": q, "weight_inv": np.linalg.inv(q)},
            "coupling": {
                "start_w": start_w[0], "start_b": start_b,
                "end_w": zeros((hd, c_sqz)), "end_b": zeros(c_sqz), "wn": wn,
            },
        })
    tree = {"encoder": encoder, "decoder": _stack(blocks)}
    if cfg.n_speakers > 1:
        tree["emb_g"] = _uniform(gen, (cfg.n_speakers, cfg.gin_channels), 0.1)
    return _as_float32(tree)


def _init_hifi_gan(gen: torch.Generator, cfg: HiFiGanConfig) -> Params:
    def conv(k, c_in, c_out):
        w, b = _conv_init(gen, k, c_in, c_out)
        return {"w": w, "b": b}

    c0 = cfg.upsample_initial_channel
    params: Params = {"conv_pre": conv(7, cfg.num_mels, c0)}
    ups, ch = [], c0
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        c_out = c0 // (2 ** (i + 1))
        ups.append(conv(k, ch, c_out))
        ch = c_out
    params["ups"] = ups
    resblocks = []
    for i in range(len(cfg.upsample_rates)):
        c = c0 // (2 ** (i + 1))
        for ks, ds in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            if cfg.resblock == "1":
                resblocks.append({
                    "convs1": [conv(ks, c, c) for _ in ds],
                    "convs2": [conv(ks, c, c) for _ in ds],
                })
            else:
                resblocks.append({"convs": [conv(ks, c, c) for _ in ds]})
    params["resblocks"] = resblocks
    params["conv_post"] = conv(7, ch, 1)
    return params


def _init_waveglow(gen: torch.Generator, cfg: WaveGlowConfig) -> Params:
    """The JAX init: normal x 0.05 weights, normal x 0.01 biases, a QR
    rotation with det > 0 (and its inverse) per invertible 1x1, and zero
    end convs, so every coupling starts as the identity."""
    def conv(k, c_in, c_out):
        return _normal(gen, (k, c_in, c_out), 0.05), _normal(gen, (c_out,), 0.01)

    up_w, up_b = conv(cfg.upsample_kernel, cfg.mel_channels, cfg.mel_channels)
    params: Params = {"upsample": {"w": up_w, "b": up_b}, "flows": []}
    ch = cfg.wn_channels
    for k in range(cfg.flows):
        c = cfg.channels_at_flow(k)
        n_half = c // 2
        w = np.linalg.qr(_normal(gen, (c, c)).astype(np.float64))[0]
        if np.linalg.det(w) < 0:
            w[:, 0] *= -1
        start_w, start_b = conv(1, n_half, ch)
        cond_w, cond_b = conv(1, cfg.mel_channels * cfg.groups, 2 * ch * cfg.wn_layers)
        in_w, in_b, rs_w, rs_b = [], [], [], []
        for i in range(cfg.wn_layers):
            wi, bi = conv(cfg.wn_kernel_size, ch, 2 * ch)
            in_w.append(wi)
            in_b.append(bi)
            wr, br = conv(1, ch, 2 * ch if i < cfg.wn_layers - 1 else ch)
            rs_w.append(wr[0])
            rs_b.append(br)
        params["flows"].append({
            "convinv": {"w": w, "w_inv": np.linalg.inv(w)},
            "wn": {
                "start_w": start_w[0], "start_b": start_b,
                "cond_w": cond_w[0], "cond_b": cond_b,
                "in_w": in_w, "in_b": in_b, "res_skip_w": rs_w, "res_skip_b": rs_b,
                "end_w": np.zeros((ch, 2 * n_half)), "end_b": np.zeros(2 * n_half),
            },
        })
    return _as_float32(params)


def _init_tacotron2(gen: torch.Generator, cfg: Tacotron2Config) -> Params:
    """The JAX init: xavier-uniform linears (uniform 1/sqrt(in) biases),
    uniform 1/sqrt(H) LSTM gates with one fused bias, xavier-over-taps convs
    with zero biases and identity BatchNorm statistics."""
    e = cfg.encoder_embedding_dim

    def linear(c_in, c_out, bias=True):
        p = {"w": _xavier(gen, (c_in, c_out), c_in, c_out)}
        if bias:
            p["b"] = _uniform(gen, (c_out,), 1.0 / math.sqrt(c_in))
        return p

    def conv_bn(k, c_in, c_out):
        return {
            "w": _uniform(gen, (k, c_in, c_out), math.sqrt(6.0 / (k * (c_in + c_out)))),
            "b": np.zeros(c_out),
            "bn": {"gamma": np.ones(c_out), "beta": np.zeros(c_out),
                   "mean": np.zeros(c_out), "var": np.ones(c_out)},
        }

    def lstm(c_in, hidden):
        bound = 1.0 / math.sqrt(hidden)
        return {"w_ih": _uniform(gen, (c_in, 4 * hidden), bound),
                "w_hh": _uniform(gen, (hidden, 4 * hidden), bound),
                "b": _uniform(gen, (4 * hidden,), bound)}

    post_convs = []
    for i in range(cfg.postnet_n_convolutions):
        c_in = cfg.mel_channels if i == 0 else cfg.postnet_embedding_dim
        last = i == cfg.postnet_n_convolutions - 1
        c_out = cfg.mel_channels if last else cfg.postnet_embedding_dim
        post_convs.append(conv_bn(cfg.postnet_kernel_size, c_in, c_out))
    std = math.sqrt(2.0 / (cfg.num_symbols + cfg.symbols_embedding_dim))
    k_loc = cfg.attention_location_kernel_size
    return _as_float32({
        "embedding": _uniform(gen, (cfg.num_symbols, cfg.symbols_embedding_dim),
                              math.sqrt(3.0) * std),
        "encoder": {
            "convs": [conv_bn(cfg.encoder_kernel_size, e, e)
                      for _ in range(cfg.encoder_n_convolutions)],
            "lstm_fw": lstm(e, cfg.encoder_lstm_dim),
            "lstm_bw": lstm(e, cfg.encoder_lstm_dim),
        },
        "decoder": {
            "prenet": [linear(cfg.mel_channels, cfg.prenet_dim, bias=False),
                       linear(cfg.prenet_dim, cfg.prenet_dim, bias=False)],
            "attention_rnn": lstm(cfg.prenet_dim + e, cfg.attention_rnn_dim),
            "attention": {
                "query": linear(cfg.attention_rnn_dim, cfg.attention_dim, bias=False),
                "memory": linear(e, cfg.attention_dim, bias=False),
                "v": linear(cfg.attention_dim, 1, bias=False),
                "location_conv": _uniform(gen, (k_loc, 2, cfg.attention_location_n_filters),
                                          math.sqrt(6.0 / (k_loc * 2 + 2))),
                "location_dense": linear(cfg.attention_location_n_filters, cfg.attention_dim,
                                         bias=False),
            },
            "decoder_rnn": lstm(cfg.attention_rnn_dim + e, cfg.decoder_rnn_dim),
            "projection": linear(cfg.decoder_rnn_dim + e, cfg.mel_channels),
            "gate": linear(cfg.decoder_rnn_dim + e, 1),
        },
        "postnet": {"convs": post_convs},
    })


def init_discriminators(gen: torch.Generator) -> Params:
    """HiFi-GAN's multi-period and multi-scale discriminators in the native
    layout: uniform 1/sqrt(fan_in) weights and biases, fan_in counting the
    per-group inputs, as the JAX package's init."""
    from larynx_tpu_torch.models.hifi_gan.discriminators import P_CHANNELS, PERIODS, S_LAYERS

    def conv(shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        return {"w": _uniform(gen, shape, bound), "b": _uniform(gen, (shape[-1],), bound)}

    periods = [{
        "convs": [conv((5, 1, c_in, c_out), c_in * 5) for c_in, c_out in P_CHANNELS]
        + [conv((5, 1, 1024, 1024), 1024 * 5)],
        "post": conv((3, 1, 1024, 1), 1024 * 3),
    } for _ in PERIODS]
    scales = [{
        "convs": [conv((k, c_in // groups, c_out), (c_in // groups) * k)
                  for c_in, c_out, k, _stride, groups in S_LAYERS],
        "post": conv((3, 1024, 1), 1024 * 3),
    } for _ in range(3)]
    return _as_float32({"periods": periods, "scales": scales})


def _as_float32(tree):
    if isinstance(tree, dict):
        return {k: _as_float32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_float32(v) for v in tree]
    return np.asarray(tree, dtype=np.float32)


def init_params(generator: torch.Generator, cfg) -> Params:
    """Random native-layout (numpy) params for a GlowTTS, HiFi-GAN, WaveGlow
    or Tacotron2 config, or for ``"discriminators"`` (HiFi-GAN's)."""
    if cfg == "discriminators":
        return init_discriminators(generator)
    if isinstance(cfg, GlowTTSConfig):
        return _init_glow_tts(generator, cfg)
    if isinstance(cfg, HiFiGanConfig):
        return _init_hifi_gan(generator, cfg)
    if isinstance(cfg, WaveGlowConfig):
        return _init_waveglow(generator, cfg)
    if isinstance(cfg, Tacotron2Config):
        return _init_tacotron2(generator, cfg)
    raise TypeError(f"no init for {type(cfg).__name__}")
