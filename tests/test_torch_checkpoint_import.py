"""Checkpoint import in the port (``larynx_tpu_torch.convert.torch_import``,
``convert.onnx_import`` and each family's loader) against ``larynx_tpu``'s,
on CPU.

Named state dicts are built here from the JAX ``init_params`` trees by the
inverse of the converters' names (GlowTTS, HiFi-GAN), after NVIDIA's
WaveGlow naming (``tests/test_waveglow.py``'s synthetic state dict), or
taken from the NVIDIA-layout torch oracle of ``tests/test_tacotron2.py``.
Both packages convert them, from numpy, from ``.pth`` files and from
``.onnx`` files (written by ``tests/test_onnx_import.py``'s protobuf
writer).

Tolerances: none.  Both converters are the same numpy operations on the
same arrays, so the trees must be equal bit for bit, and a voice loaded
from a ``.pth`` or ``.onnx`` whose weights are the ``.npz``'s must give the
same audio, 0 LSB.
"""

import json

import jax
import numpy as np
import pytest
import torch

import larynx_tpu
from larynx_tpu import glow_tts as j_glow
from larynx_tpu import hifi_gan as j_hifi
from larynx_tpu import tacotron2 as j_t2
from larynx_tpu import waveglow as j_wg
from larynx_tpu.constants import InferenceBackend as JBackend
from larynx_tpu.convert import onnx_import as j_onnx
from larynx_tpu.convert import torch_import as j_torch
from larynx_tpu.convert.native import save_params
from larynx_tpu.models.glow_tts import config_from_voice_json as j_glow_config
from larynx_tpu.models.glow_tts import init_params as j_glow_init
from larynx_tpu.models.hifi_gan import hifi_gan_config_from_json as j_hifi_config
from larynx_tpu.models.hifi_gan import init_params as j_hifi_init
from larynx_tpu.models.tacotron2 import tacotron2_config_from_voice_json as j_t2_config
from larynx_tpu.models.waveglow import waveglow_config_from_json as j_wg_config

import larynx_tpu_torch
from larynx_tpu_torch import glow_tts as t_glow
from larynx_tpu_torch import hifi_gan as t_hifi
from larynx_tpu_torch import tacotron2 as t_t2
from larynx_tpu_torch import waveglow as t_wg
from larynx_tpu_torch.constants import InferenceBackend
from larynx_tpu_torch.convert import onnx_import as t_onnx
from larynx_tpu_torch.convert import torch_import as t_torch
from larynx_tpu_torch.models.glow_tts import config_from_voice_json as t_glow_config
from larynx_tpu_torch.models.hifi_gan.config import hifi_gan_config_from_json as t_hifi_config
from larynx_tpu_torch.models.tacotron2 import tacotron2_config_from_voice_json as t_t2_config
from larynx_tpu_torch.models.waveglow import waveglow_config_from_json as t_wg_config

from test_onnx_import import make_onnx_bytes
from test_tacotron2 import _Tacotron2
from test_torch_pipeline import PHONEME_TABLE, VOCODER_CONFIG, VOICE_CONFIG
from test_torch_tacotron2 import VOICE_CONFIG as T2_VOICE_CONFIG

GLOW_MULTI = dict(VOICE_CONFIG, model=dict(VOICE_CONFIG["model"], n_speakers=4, gin_channels=32))
HIFI_R2 = {  # a ResBlock2 geometry, as vctk_small
    "audio": {"num_mels": 80, "sampling_rate": 22050},
    "model": {
        "resblock": "2", "upsample_rates": [8, 8, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4],
        "upsample_initial_channel": 16, "resblock_kernel_sizes": [3, 5],
        "resblock_dilation_sizes": [[1, 2], [2, 6]],
    },
}
WAVEGLOW = {
    "mel_channels": 8, "sampling_rate": 22050, "flows": 4, "groups": 8, "early_every": 2,
    "early_size": 2, "wn_kernel_size": 3, "wn_channels": 32, "wn_layers": 2,
    "upsample_kernel": 128, "upsample_stride": 64, "sigma": 0.0,
}
BACKENDS = [None, InferenceBackend.JAX, InferenceBackend.PYTORCH, InferenceBackend.ONNX]


# -----------------------------------------------------------------------------
# Trees, and state dicts by the inverse of the converters' names


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def assert_trees_equal(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert got.keys() == want.keys()
    for key, value in got.items():
        assert value.dtype == want[key].dtype, key
        np.testing.assert_array_equal(value, want[key], err_msg=key)


def _conv(w):
    """[k, C_in, C_out] -> torch Conv1d [C_out, C_in, k]."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 1, 0)))


def _mat(w):
    """[C_in, C_out] -> torch 1x1 Conv1d [C_out, C_in, 1]."""
    return np.ascontiguousarray(np.asarray(w).T[:, :, None])


def _put(sd, prefix, w, b=None, weight_norm=False):
    """A weight (and bias) under ``prefix``; with ``weight_norm`` as the
    (weight_g, weight_v) pair that folds back to it (v = 2.5 w)."""
    # contiguous, as a state dict loaded from a file is: numpy's sums over a
    # strided array round in another order
    w = np.ascontiguousarray(w, dtype=np.float32)
    if weight_norm:
        v = np.ascontiguousarray(2.5 * w, dtype=np.float32)
        sd[f"{prefix}.weight_v"] = v
        sd[f"{prefix}.weight_g"] = np.sqrt(np.sum(np.square(w), axis=tuple(range(1, w.ndim)),
                                                  keepdims=True)).astype(np.float32)
    else:
        sd[f"{prefix}.weight"] = w
    if b is not None:
        sd[f"{prefix}.bias"] = np.ascontiguousarray(b, dtype=np.float32)


def glow_tts_state_dict(tree, cfg):
    """The reference FlowGenerator's state dict for a native GlowTTS tree."""
    sd = {}
    enc = tree["encoder"]
    sd["encoder.emb.weight"] = np.asarray(enc["emb"])
    if cfg.prenet:
        for i, layer in enumerate(enc["prenet"]["layers"]):
            _put(sd, f"encoder.pre.conv_layers.{i}", _conv(layer["w"]), layer["b"])
            sd[f"encoder.pre.norm_layers.{i}.gamma"] = np.asarray(layer["ln_g"])
            sd[f"encoder.pre.norm_layers.{i}.beta"] = np.asarray(layer["ln_b"])
        _put(sd, "encoder.pre.proj", _mat(enc["prenet"]["proj_w"]), enc["prenet"]["proj_b"])
    layers = enc["layers"]
    for i in range(cfg.n_layers_enc):
        a = f"encoder.encoder.attn_layers.{i}"
        for n in "qkvo":
            _put(sd, f"{a}.conv_{n}", _mat(layers[f"{n}_w"][i]), layers[f"{n}_b"][i])
        for j in (1, 2):
            sd[f"encoder.encoder.norm_layers_{j}.{i}.gamma"] = np.asarray(layers[f"ln{j}_g"][i])
            sd[f"encoder.encoder.norm_layers_{j}.{i}.beta"] = np.asarray(layers[f"ln{j}_b"][i])
            _put(sd, f"encoder.encoder.ffn_layers.{i}.conv_{j}", _conv(layers[f"conv{j}_w"][i]),
                 layers[f"conv{j}_b"][i])
        if cfg.window_size is not None:
            sd[f"{a}.emb_rel_k"] = np.asarray(layers["emb_rel_k"][i])[None]
            sd[f"{a}.emb_rel_v"] = np.asarray(layers["emb_rel_v"][i])[None]
    _put(sd, "encoder.proj_m", _mat(enc["proj_m_w"]), enc["proj_m_b"])
    if not cfg.mean_only:
        _put(sd, "encoder.proj_s", _mat(enc["proj_s_w"]), enc["proj_s_b"])
    dp = enc["dp"]
    for j in (1, 2):
        _put(sd, f"encoder.proj_w.conv_{j}", _conv(dp[f"conv{j}_w"]), dp[f"conv{j}_b"])
        sd[f"encoder.proj_w.norm_{j}.gamma"] = np.asarray(dp[f"ln{j}_g"])
        sd[f"encoder.proj_w.norm_{j}.beta"] = np.asarray(dp[f"ln{j}_b"])
    _put(sd, "encoder.proj_w.proj", _mat(dp["proj_w"]), dp["proj_b"])

    dec, hd = tree["decoder"], cfg.dec_channels
    for b in range(cfg.n_blocks_dec):
        sd[f"decoder.flows.{3 * b}.logs"] = np.asarray(dec["actnorm"]["logs"][b])[None, :, None]
        sd[f"decoder.flows.{3 * b}.bias"] = np.asarray(dec["actnorm"]["bias"][b])[None, :, None]
        sd[f"decoder.flows.{3 * b + 1}.weight"] = np.asarray(dec["invconv"]["weight"][b])
        cp, c = f"decoder.flows.{3 * b + 2}", dec["coupling"]
        _put(sd, f"{cp}.start", _mat(c["start_w"][b]), c["start_b"][b], weight_norm=True)
        _put(sd, f"{cp}.end", _mat(c["end_w"][b]), c["end_b"][b])
        wn = c["wn"]
        for i in range(cfg.n_block_layers):
            _put(sd, f"{cp}.wn.in_layers.{i}", _conv(wn["in_w"][b][i]), wn["in_b"][b][i],
                 weight_norm=True)
            w, bias = np.asarray(wn["res_skip_w"][b][i]), np.asarray(wn["res_skip_b"][b][i])
            if i == cfg.n_block_layers - 1:  # skip only: the converter zero-pads the res half
                w, bias = w[:, hd:], bias[hd:]
            _put(sd, f"{cp}.wn.res_skip_layers.{i}", _mat(w), bias, weight_norm=True)
        if cfg.gin_channels > 0:
            _put(sd, f"{cp}.wn.cond_layer", _conv(wn["cond_w"][b]), wn["cond_b"][b],
                 weight_norm=True)
    if cfg.n_speakers > 1:
        sd["emb_g.weight"] = np.asarray(tree["emb_g"])
    return sd


def hifi_gan_state_dict(tree, weight_norm=False):
    """The reference HiFi-GAN Generator's state dict for a native tree."""
    sd = {}
    _put(sd, "conv_pre", _conv(tree["conv_pre"]["w"]), tree["conv_pre"]["b"], weight_norm)
    for i, up in enumerate(tree["ups"]):  # ConvTranspose1d [C_in, C_out, k]
        _put(sd, f"ups.{i}", np.transpose(np.asarray(up["w"]), (1, 2, 0)), up["b"], weight_norm)
    for i, block in enumerate(tree["resblocks"]):
        for name, convs in block.items():
            for j, conv in enumerate(convs):
                _put(sd, f"resblocks.{i}.{name}.{j}", _conv(conv["w"]), conv["b"], weight_norm)
    _put(sd, "conv_post", _conv(tree["conv_post"]["w"]), tree["conv_post"]["b"], weight_norm)
    return sd


def waveglow_state_dict(cfg, seed, fused_cond=True):
    """An NVIDIA-named WaveGlow state dict with weight-norm pairs, as
    ``tests/test_waveglow.py::test_torch_import_roundtrip`` builds it."""
    gen = torch.Generator().manual_seed(seed)

    def t(*shape, scale=0.1):
        return (scale * torch.randn(*shape, generator=gen)).numpy()

    sd = {"upsample.weight": t(cfg.mel_channels, cfg.mel_channels, cfg.upsample_kernel),
          "upsample.bias": t(cfg.mel_channels)}
    ch, cond_in = cfg.wn_channels, cfg.mel_channels * cfg.groups
    for k in range(cfg.flows):
        c = cfg.channels_at_flow(k)
        q, _ = torch.linalg.qr(torch.randn(c, c, generator=gen))
        sd[f"convinv.{k}.conv.weight"] = q[:, :, None].numpy()
        p = f"WN.{k}"
        _put(sd, f"{p}.start", t(ch, c // 2, 1), t(ch), weight_norm=True)
        if fused_cond:
            _put(sd, f"{p}.cond_layer", t(2 * ch * cfg.wn_layers, cond_in, 1),
                 t(2 * ch * cfg.wn_layers), weight_norm=True)
        for i in range(cfg.wn_layers):
            if not fused_cond:
                _put(sd, f"{p}.cond_layers.{i}", t(2 * ch, cond_in, 1), t(2 * ch),
                     weight_norm=True)
            _put(sd, f"{p}.in_layers.{i}", t(2 * ch, ch, cfg.wn_kernel_size), t(2 * ch),
                 weight_norm=True)
            rs = 2 * ch if i < cfg.wn_layers - 1 else ch
            _put(sd, f"{p}.res_skip_layers.{i}", t(rs, ch, 1), t(rs), weight_norm=True)
        _put(sd, f"{p}.end", t(c, ch, 1, scale=0.01), t(c, scale=0.01))
    return sd


def tacotron2_state_dict(voice_config, seed, gate_bias=None):
    """The NVIDIA-layout torch oracle's state dict, BatchNorm statistics
    randomised so that they reach the tree."""
    torch.manual_seed(seed)
    model = _Tacotron2(j_t2_config(voice_config))
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.normal_(0.0, 0.1)
        elif name.endswith("running_var"):
            buf.uniform_(0.5, 1.5)
    if gate_bias is not None:
        model.decoder.gate_layer.linear_layer.bias.data.fill_(gate_bias)
    return {k: v.detach().numpy() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _glow_tree(voice_config, seed):
    return jax.tree.map(np.asarray, j_glow_init(jax.random.PRNGKey(seed),
                                                j_glow_config(voice_config)))


def _hifi_tree(config, seed):
    return jax.tree.map(np.asarray, j_hifi_init(jax.random.PRNGKey(seed), j_hifi_config(config)))


# -----------------------------------------------------------------------------
# The converters


def _glow_case(voice_config):
    sd = glow_tts_state_dict(_glow_tree(voice_config, 0), j_glow_config(voice_config))
    return (j_torch.glow_tts_params_from_state_dict(sd, j_glow_config(voice_config)),
            t_torch.glow_tts_params_from_state_dict(sd, t_glow_config(voice_config)))


def _hifi_case(config, weight_norm):
    sd = hifi_gan_state_dict(_hifi_tree(config, 1), weight_norm)
    j_cfg, t_cfg = j_hifi_config(config), t_hifi_config(config)
    return (j_torch.hifi_gan_params_from_state_dict(sd, j_cfg.upsample_rates,
                                                    j_cfg.resblock_kernel_sizes, j_cfg.resblock),
            t_torch.hifi_gan_params_from_state_dict(sd, t_cfg.upsample_rates,
                                                    t_cfg.resblock_kernel_sizes, t_cfg.resblock))


def _waveglow_case(fused_cond):
    sd = waveglow_state_dict(j_wg_config(WAVEGLOW), 2, fused_cond)
    return (j_torch.waveglow_params_from_state_dict(sd, j_wg_config(WAVEGLOW)),
            t_torch.waveglow_params_from_state_dict(sd, t_wg_config(WAVEGLOW)))


def _tacotron2_case():
    sd = tacotron2_state_dict(T2_VOICE_CONFIG, 3)
    return (j_torch.tacotron2_params_from_state_dict(sd, j_t2_config(T2_VOICE_CONFIG)),
            t_torch.tacotron2_params_from_state_dict(sd, t_t2_config(T2_VOICE_CONFIG)))


CONVERTER_CASES = {
    "glow_tts": lambda: _glow_case(VOICE_CONFIG),
    "glow_tts multi-speaker": lambda: _glow_case(GLOW_MULTI),
    "hifi_gan resblock 1": lambda: _hifi_case(VOCODER_CONFIG, False),
    "hifi_gan resblock 2, weight norm": lambda: _hifi_case(HIFI_R2, True),
    "waveglow fused cond": lambda: _waveglow_case(True),
    "waveglow per-layer cond": lambda: _waveglow_case(False),
    "tacotron2": _tacotron2_case,
}


@pytest.mark.parametrize("case", list(CONVERTER_CASES))
def test_state_dict_converters_match_jax(case):
    want, got = CONVERTER_CASES[case]()
    assert_trees_equal(got, want)
    if case == "glow_tts multi-speaker":
        assert "emb_g" in got and "cond_w" in got["decoder"]["coupling"]["wn"]


def test_tacotron2_num_symbols_mismatch_raises_as_jax():
    sd = tacotron2_state_dict(T2_VOICE_CONFIG, 3)
    other = dict(T2_VOICE_CONFIG, model=dict(T2_VOICE_CONFIG["model"], num_symbols=47))
    with pytest.raises(ValueError) as want:
        j_torch.tacotron2_params_from_state_dict(sd, j_t2_config(other))
    with pytest.raises(ValueError) as got:
        t_torch.tacotron2_params_from_state_dict(sd, t_t2_config(other))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("layout", ["model", "generator", "state_dict", "bare", "module"])
def test_load_torch_state_dict_matches_jax(tmp_path, layout):
    """The key under which a checkpoint holds its tensors, found or given."""
    sd = {k: torch.tensor(v) for k, v in hifi_gan_state_dict(
        _hifi_tree(HIFI_R2, 1)).items()}
    path = tmp_path / "generator.pth"
    if layout == "bare":
        torch.save(sd, path)
    elif layout == "module":
        module = torch.nn.Module()
        for i, (name, value) in enumerate(sorted(sd.items())):
            module.register_buffer(f"b{i}", value)
        torch.save(module, path)
    else:
        torch.save({layout: sd, "iteration": 7}, path)
    for key in (None, layout if layout not in ("bare", "module") else None):
        got = t_torch.load_torch_state_dict(path, key=key)
        want = j_torch.load_torch_state_dict(path, key=key)
        assert_trees_equal(got, want)
        assert len(got) == len(sd)


def test_load_torch_state_dict_without_tensors_raises_as_jax(tmp_path):
    path = tmp_path / "empty.pth"
    torch.save({"model": {"step": 3}}, path)
    with pytest.raises(ValueError) as want:
        j_torch.load_torch_state_dict(path)
    with pytest.raises(ValueError) as got:
        t_torch.load_torch_state_dict(path)
    assert str(got.value) == str(want.value)


# -----------------------------------------------------------------------------
# ONNX


def _wn_graph(base, rng, spelling, out_ch=16, in_ch=8, k=3):
    g = rng.standard_normal((out_ch, 1, 1)).astype(np.float32)
    v = rng.standard_normal((out_ch, in_ch, k)).astype(np.float32)
    init = {f"{base}.weight_g": g, f"{base}.weight_v": v}
    if spelling == "reducel2":
        nodes = [("ReduceL2", [f"{base}.weight_v"], ["n"], {"axes": [1, 2], "keepdims": 1})]
    else:
        init["two"] = np.asarray(2.0, dtype=np.float32)
        nodes = [("Pow", [f"{base}.weight_v", "two"], ["sq"]),
                 ("ReduceSum", ["sq"], ["ssq"], {"axes": [1, 2], "keepdims": 1}),
                 ("Sqrt", ["ssq"], ["n"])]
    nodes += [("Div", [f"{base}.weight_v", "n"], ["u"]),
              ("Mul", [f"{base}.weight_g", "u"], ["w"]),
              ("Conv", ["x", "w"], ["y"], {"dilations": [1]})]
    return init, nodes


@pytest.mark.parametrize("spelling", ["reducel2", "pow"])
def test_in_graph_weight_norm_folds_as_jax(tmp_path, spelling):
    init, nodes = _wn_graph("conv", np.random.default_rng(4), spelling)
    path = tmp_path / "m.onnx"
    path.write_bytes(make_onnx_bytes(init, nodes))
    got, want = t_onnx.onnx_state_dict(path), j_onnx.onnx_state_dict(path)
    assert_trees_equal(got, want)
    g, v = init["conv.weight_g"], init["conv.weight_v"]
    np.testing.assert_allclose(got["conv.weight"],
                               g * v / np.sqrt(np.sum(v * v, axis=(1, 2), keepdims=True)),
                               rtol=1e-6)


def test_onnx_graph_parse_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    init = {"a.weight": rng.standard_normal((4, 3, 5)).astype(np.float32),
            "model.b.bias": rng.standard_normal(7).astype(np.float32),
            "c.ids": np.arange(6, dtype=np.int64).reshape(2, 3),
            "d.half": rng.standard_normal((2, 2)).astype(np.float16)}
    nodes = [("MatMul", ["x", "a.weight"], ["y"]), ("LeakyRelu", ["y"], ["z"], {"alpha": 0.1})]
    path = tmp_path / "m.onnx"
    path.write_bytes(make_onnx_bytes(init, nodes))
    (t_init, t_nodes), (j_init, j_nodes) = t_onnx.read_onnx_graph(path), j_onnx.read_onnx_graph(path)
    assert_trees_equal(t_init, j_init)
    assert t_nodes == j_nodes
    assert "b.bias" in t_onnx.onnx_state_dict(path)


def test_unsupported_ops_and_diagnosis_match_jax(tmp_path):
    """A constant-folded export (numeric names) with an unknown op fails with
    the JAX importer's message, naming the op and the lost names."""
    rng = np.random.default_rng(3)
    init = {str(200 + i): rng.standard_normal((4, 4)).astype(np.float32) for i in range(8)}
    nodes = [("Conv", ["input", "200", "201"], ["300"], {"kernel_shape": [1]}),
             ("MyCustomFusedOp", ["300"], ["301"]), ("Softmax", ["301"], ["302"])]
    path = tmp_path / "generator.onnx"
    path.write_bytes(make_onnx_bytes(init, nodes))
    _, parsed = t_onnx.read_onnx_graph(path)
    assert t_onnx.unsupported_op_kinds(parsed) == j_onnx.unsupported_op_kinds(parsed) == [
        "MyCustomFusedOp"]
    with pytest.raises(t_onnx.OnnxParseError) as got:
        t_onnx.glow_tts_params_from_onnx(path, t_glow_config(VOICE_CONFIG))
    with pytest.raises(j_onnx.OnnxParseError) as want:
        j_onnx.glow_tts_params_from_onnx(path, j_glow_config(VOICE_CONFIG))
    assert str(got.value) == str(want.value)
    assert "MyCustomFusedOp" in str(got.value) and "constant-folded" in str(got.value)


@pytest.mark.parametrize("family", ["glow_tts", "hifi_gan"])
def test_onnx_converters_match_jax(tmp_path, family):
    """A state dict written as ONNX initializers, HiFi-GAN's upsampling
    weights as in-graph weight norm, converts as in the JAX package."""
    if family == "glow_tts":
        sd = glow_tts_state_dict(_glow_tree(VOICE_CONFIG, 0), j_glow_config(VOICE_CONFIG))
        nodes = []
    else:
        sd = hifi_gan_state_dict(_hifi_tree(HIFI_R2, 1), weight_norm=True)
        nodes = []
        for i in range(4):
            base = f"ups.{i}"
            nodes += [("ReduceL2", [f"{base}.weight_v"], [f"n{i}"], {"axes": [1, 2],
                                                                    "keepdims": 1}),
                      ("Div", [f"{base}.weight_v", f"n{i}"], [f"u{i}"]),
                      ("Mul", [f"{base}.weight_g", f"u{i}"], [f"w{i}"]),
                      ("ConvTranspose", ["x", f"w{i}"], [f"y{i}"], {"strides": [2]})]
    path = tmp_path / "generator.onnx"
    path.write_bytes(make_onnx_bytes({f"model.{k}": v for k, v in sd.items()}, nodes))
    if family == "glow_tts":
        got = t_onnx.glow_tts_params_from_onnx(path, t_glow_config(VOICE_CONFIG))
        want = j_onnx.glow_tts_params_from_onnx(path, j_glow_config(VOICE_CONFIG))
    else:
        got = t_onnx.hifi_gan_params_from_onnx(path, t_hifi_config(HIFI_R2))
        want = j_onnx.hifi_gan_params_from_onnx(path, j_hifi_config(HIFI_R2))
    assert_trees_equal(got, want)


# -----------------------------------------------------------------------------
# The loaders: order, backend, key, error


def _stage(model_dir, config, files):
    """A model dir with ``config.json`` and each named checkpoint file."""
    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / "config.json").write_text(json.dumps(config), encoding="utf-8")
    for name, write in files.items():
        write(model_dir / name)
    return model_dir


def _npz(tree):
    return lambda path: save_params(path, tree)


def _pth(sd, key):
    def write(path):
        tensors = {k: torch.tensor(v) for k, v in sd.items()}
        torch.save(tensors if key is None else {key: tensors}, path)
    return write


def _onnx(sd):
    return lambda path: path.write_bytes(make_onnx_bytes(sd))


def _family_dirs(root):
    """Per family: (dir with every format it reads, each holding other
    weights; JAX loader; port loader; {format: the tree it holds})."""
    out = {}
    glow_cfg = j_glow_config(VOICE_CONFIG)
    trees = {}
    files = {}
    for fmt, seed in (("npz", 10), ("pth", 11), ("onnx", 12)):
        sd = glow_tts_state_dict(_glow_tree(VOICE_CONFIG, seed), glow_cfg)
        trees[fmt] = j_torch.glow_tts_params_from_state_dict(sd, glow_cfg)
        files[f"generator.{fmt}"] = {"npz": _npz(trees[fmt]), "pth": _pth(sd, "model"),
                                     "onnx": _onnx(sd)}[fmt]
    out["glow_tts"] = (_stage(root / "glow_tts", VOICE_CONFIG, files),
                       lambda d, b: j_glow.load_glow_tts_artifacts(d, b)[0],
                       lambda d, b: t_glow.load_glow_tts_artifacts(d, b)[0], trees)

    hifi_cfg = j_hifi_config(HIFI_R2)
    trees, files = {}, {}
    for fmt, seed in (("npz", 20), ("pth", 21), ("onnx", 22)):
        sd = hifi_gan_state_dict(_hifi_tree(HIFI_R2, seed), weight_norm=(fmt == "pth"))
        trees[fmt] = j_torch.hifi_gan_params_from_state_dict(
            sd, hifi_cfg.upsample_rates, hifi_cfg.resblock_kernel_sizes, hifi_cfg.resblock)
        files[f"generator.{fmt}"] = {"npz": _npz(trees[fmt]), "pth": _pth(sd, "generator"),
                                     "onnx": _onnx(sd)}[fmt]
    out["hifi_gan"] = (_stage(root / "hifi_gan", HIFI_R2, files),
                       lambda d, b: j_hifi.load_hifi_gan_artifacts(d, b)[0],
                       lambda d, b: t_hifi.load_hifi_gan_artifacts(d, b)[0], trees)

    wg_cfg = j_wg_config(WAVEGLOW)
    trees, files = {}, {}
    for name, seed in (("generator.npz", 30), ("b_waveglow.pth", 31), ("a_waveglow.pth", 32),
                       ("waveglow.pt", 33)):
        sd = waveglow_state_dict(wg_cfg, seed)
        trees[name] = j_torch.waveglow_params_from_state_dict(sd, wg_cfg)
        files[name] = _npz(trees[name]) if name.endswith(".npz") else _pth(sd, "model")
    out["waveglow"] = (_stage(root / "waveglow", WAVEGLOW, files),
                       lambda d, b: j_wg.load_waveglow_artifacts(d, b)[0],
                       lambda d, b: t_wg.load_waveglow_artifacts(d, b)[0], trees)

    t2_cfg = j_t2_config(T2_VOICE_CONFIG)
    trees, files = {}, {}
    for fmt, seed in (("npz", 40), ("pth", 41)):
        sd = tacotron2_state_dict(T2_VOICE_CONFIG, seed)
        trees[fmt] = j_torch.tacotron2_params_from_state_dict(sd, t2_cfg)
        files[f"generator.{fmt}"] = _npz(trees[fmt]) if fmt == "npz" else _pth(sd, "state_dict")
    out["tacotron2"] = (_stage(root / "tacotron2", T2_VOICE_CONFIG, files),
                        lambda d, b: j_t2.load_tacotron2_artifacts(d, b)[0],
                        lambda d, b: t_t2.load_tacotron2_artifacts(d, b)[0], trees)
    return out


@pytest.fixture(scope="module")
def family_dirs(tmp_path_factory):
    return _family_dirs(tmp_path_factory.mktemp("checkpoint_families"))


# the tree each (family, backend) loads: a named backend narrows the order
# to its format where the family has one; otherwise every format, in order
EXPECTED = {
    "glow_tts": {None: "npz", "jax": "npz", "pytorch": "pth", "onnx": "onnx"},
    "hifi_gan": {None: "npz", "jax": "npz", "pytorch": "pth", "onnx": "onnx"},
    "waveglow": {None: "generator.npz", "jax": "generator.npz", "pytorch": "a_waveglow.pth",
                 "onnx": "generator.npz"},
    "tacotron2": {None: "npz", "jax": "npz", "pytorch": "pth", "onnx": "npz"},
}


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: getattr(b, "value", "none"))
@pytest.mark.parametrize("family", list(EXPECTED))
def test_loaders_keep_jax_order_and_backend(family_dirs, family, backend):
    model_dir, j_load, t_load, trees = family_dirs[family]
    got = t_load(model_dir, backend)
    j_backend = None if backend is None else JBackend(backend.value)
    assert_trees_equal(got, j_load(model_dir, j_backend))
    want = trees[EXPECTED[family][getattr(backend, "value", None)]]
    assert_trees_equal(got, jax.tree.map(np.asarray, want))


@pytest.mark.parametrize("family", list(EXPECTED))
def test_loaders_fall_through_to_the_next_format(family_dirs, tmp_path, family):
    """With no backend, a dir without ``generator.npz`` loads the next format."""
    model_dir, j_load, t_load, trees = family_dirs[family]
    copy = tmp_path / family
    copy.mkdir()
    for path in model_dir.iterdir():
        if path.name != "generator.npz":
            (copy / path.name).symlink_to(path)
    got = t_load(copy, None)
    assert_trees_equal(got, j_load(copy, None))
    want = {"glow_tts": "pth", "hifi_gan": "pth", "waveglow": "a_waveglow.pth",
            "tacotron2": "pth"}[family]
    assert_trees_equal(got, jax.tree.map(np.asarray, trees[want]))


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: getattr(b, "value", "none"))
@pytest.mark.parametrize("family", list(EXPECTED))
def test_missing_checkpoint_raises_as_jax(tmp_path, family, backend):
    config = {"glow_tts": VOICE_CONFIG, "hifi_gan": HIFI_R2, "waveglow": WAVEGLOW,
              "tacotron2": T2_VOICE_CONFIG}[family]
    model_dir = _stage(tmp_path / family, config, {})
    j_load = {"glow_tts": j_glow.load_glow_tts_artifacts, "hifi_gan": j_hifi.load_hifi_gan_artifacts,
              "waveglow": j_wg.load_waveglow_artifacts,
              "tacotron2": j_t2.load_tacotron2_artifacts}[family]
    t_load = {"glow_tts": t_glow.load_glow_tts_artifacts, "hifi_gan": t_hifi.load_hifi_gan_artifacts,
              "waveglow": t_wg.load_waveglow_artifacts,
              "tacotron2": t_t2.load_tacotron2_artifacts}[family]
    j_backend = None if backend is None else JBackend(backend.value)
    with pytest.raises(FileNotFoundError) as want:
        j_load(model_dir, j_backend)
    with pytest.raises(FileNotFoundError) as got:
        t_load(model_dir, backend)
    assert str(got.value) == str(want.value)


# -----------------------------------------------------------------------------
# Voices from .pth and .onnx against the same voice from .npz

GLOW_VOICE = "en-us_torch_import-glow_tts"
T2_VOICE = "en-us_torch_import-tacotron2"
TEXT = "Hello world. A second sentence."


@pytest.fixture(scope="module")
def import_voices(tmp_path_factory):
    """A GlowTTS voice, a Tacotron2 voice (gate bias -50: no stop) and
    ``hifi_gan/vctk_small``, each with an ``.npz`` converted from the state
    dict that its ``.pth`` (and ``.onnx``: GlowTTS, HiFi-GAN) holds."""
    root = tmp_path_factory.mktemp("import_voices")
    phonemes = "".join(f"{i} {p}\n" for i, p in enumerate(PHONEME_TABLE))
    glow_cfg = j_glow_config(VOICE_CONFIG)
    tree = _glow_tree(VOICE_CONFIG, 0)
    rng = np.random.default_rng(0)  # give the zero-init coupling output signal
    cp = tree["decoder"]["coupling"]
    cp["end_w"] = (rng.standard_normal(cp["end_w"].shape) * 0.05).astype(np.float32)
    sd = glow_tts_state_dict(tree, glow_cfg)
    glow_dir = _stage(root / "en-us" / "torch_import-glow_tts", VOICE_CONFIG, {
        "generator.npz": _npz(j_torch.glow_tts_params_from_state_dict(sd, glow_cfg)),
        "generator.pth": _pth(sd, "model"), "generator.onnx": _onnx(sd)})
    (glow_dir / "phonemes.txt").write_text(phonemes, encoding="utf-8")

    sd = tacotron2_state_dict(T2_VOICE_CONFIG, 5, gate_bias=-50.0)
    t2_dir = _stage(root / "en-us" / "torch_import-tacotron2", T2_VOICE_CONFIG, {
        "generator.npz": _npz(j_torch.tacotron2_params_from_state_dict(
            sd, j_t2_config(T2_VOICE_CONFIG))),
        "generator.pth": _pth(sd, "state_dict")})
    (t2_dir / "phonemes.txt").write_text(phonemes, encoding="utf-8")

    for name, config in (("vctk_small", VOCODER_CONFIG), ("t2_small", T2_VOCODER)):
        cfg = j_hifi_config(config)
        sd = hifi_gan_state_dict(_hifi_tree(config, 1))
        _stage(root / "hifi_gan" / name, config, {
            "generator.npz": _npz(j_torch.hifi_gan_params_from_state_dict(
                sd, cfg.upsample_rates, cfg.resblock_kernel_sizes, cfg.resblock)),
            "generator.pth": _pth(sd, "generator"), "generator.onnx": _onnx(sd)})
    return root


T2_VOCODER = dict(HIFI_R2, audio={"num_mels": 12, "sampling_rate": 22050})


def _synthesize(voices, voice, vocoder, backend, module=larynx_tpu_torch):
    for m in (larynx_tpu, larynx_tpu_torch):  # the caches are keyed by name, not backend
        m._TTS_MODEL_CACHE.clear()
        m._VOCODER_MODEL_CACHE.clear()
        m._ENGINE_CACHE.clear()
    extra = {"device": "cpu"} if module is larynx_tpu_torch else {}
    if module is larynx_tpu and backend is not None:
        backend = JBackend(backend.value)
    try:
        return [r.audio for r in module.text_to_speech(
            TEXT, voice_or_lang=voice, vocoder_or_quality=f"hifi_gan/{vocoder}",
            custom_voices_dir=voices, no_download=True, backend=backend,
            tts_settings={"noise_scale": 0.0}, **extra)]
    finally:
        for m in (larynx_tpu, larynx_tpu_torch):
            m._TTS_MODEL_CACHE.clear()
            m._VOCODER_MODEL_CACHE.clear()
            m._ENGINE_CACHE.clear()


@pytest.fixture(scope="module")
def npz_audio(import_voices):
    """The port's audio of each ``.npz`` voice and vocoder, run once a pair
    for the backends that compare against it."""
    runs = {}

    def audio(voice, vocoder):
        if (voice, vocoder) not in runs:
            runs[voice, vocoder] = _synthesize(import_voices, voice, vocoder,
                                               InferenceBackend.JAX)
        return runs[voice, vocoder]

    return audio


@pytest.mark.parametrize("voice,vocoder,backend", [
    (GLOW_VOICE, "vctk_small", InferenceBackend.PYTORCH),
    (GLOW_VOICE, "vctk_small", InferenceBackend.ONNX),
    (T2_VOICE, "t2_small", InferenceBackend.PYTORCH),
], ids=["glow_tts-pth", "glow_tts-onnx", "tacotron2-pth"])
def test_voice_from_pth_or_onnx_matches_npz(import_voices, npz_audio, voice, vocoder, backend):
    """The same weights from a ``.pth`` or ``.onnx`` voice and vocoder give
    the ``.npz`` voice's audio, 0 LSB; the JAX package's within 2 LSB."""
    want = npz_audio(voice, vocoder)
    got = _synthesize(import_voices, voice, vocoder, backend)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.abs(w.astype(np.int32)).max() > 1000
        np.testing.assert_array_equal(g, w)
    for g, j in zip(got, _synthesize(import_voices, voice, vocoder, backend, larynx_tpu)):
        assert g.shape == j.shape and np.abs(g.astype(np.int32) - j.astype(np.int32)).max() <= 2


def test_waveglow_from_pth_matches_npz(family_dirs, tmp_path):
    """A WaveGlow ``.pth`` and the ``.npz`` of its converted tree vocode the
    same mel to the same audio (sigma 0)."""
    model_dir, _, _, trees = family_dirs["waveglow"]
    npz_dir = _stage(tmp_path / "npz", WAVEGLOW, {
        "generator.npz": _npz(trees["a_waveglow.pth"])})
    mel = np.random.default_rng(6).standard_normal((1, 8, 12)).astype(np.float32)
    got = t_wg.WaveGlowVocoder(model_dir, backend=InferenceBackend.PYTORCH).mels_to_audio(
        mel, device="cpu")
    want = t_wg.WaveGlowVocoder(npz_dir).mels_to_audio(mel, device="cpu")
    assert got.shape == (12 * 64,) and np.abs(want.astype(np.int32)).max() > 1000
    np.testing.assert_array_equal(got, want)
