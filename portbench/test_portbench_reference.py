"""The frozen plain reference against the port, on the CPU at tiny widths:
each model's stages, the engine's rules that the reference restates, and
the reference's independence from the port."""

import ast
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.conftest import tiny_config
from portbench.harness import weights
from portbench.kinds import glow_tts, hifi_gan
from portbench.kinds import waveglow as waveglow_kind
from portbench.reference import glowtts, hifigan, rules, waveglow

HERE = Path(__file__).resolve().parent


def _glow(seed=3):
    cfg = tiny_config("hifi_gan")["acoustic"]
    gen = torch.Generator().manual_seed(seed)
    params = glow_tts.weights(cfg, gen, torch.device("cpu"))
    rng = np.random.default_rng(seed)
    lengths = [7, 12, 5]
    ids = torch.zeros((3, 12), dtype=torch.int64)
    for i, n in enumerate(lengths):
        ids[i, :n] = torch.as_tensor(rng.integers(1, cfg["num_symbols"], size=n))
    glow_tts.calibrate(params, cfg, ids, torch.as_tensor(lengths), 6.0, 4.0)
    return cfg, params, ids, torch.as_tensor(lengths)


def _port_glow_cfg(cfg):
    from larynx_tpu_torch.models.glow_tts.config import GlowTTSConfig

    names = {f.name for f in dataclasses.fields(GlowTTSConfig)}
    return GlowTTSConfig(**{k: v for k, v in cfg.items() if k in names})


def test_glow_encode_and_decode_match_the_port():
    from larynx_tpu_torch.models.glow_tts import model as glow_model

    cfg, params, ids, lengths = _glow()
    pcfg = _port_glow_cfg(cfg)
    x_m, _x_logs, logw, w_ceil, y_len, _mask = glow_model.encode(
        params, pcfg, ids, lengths, length_scale=6.0)
    ref = glowtts.encode(weights.to_dtype(params, torch.float64), cfg, ids, lengths, 6.0)
    torch.testing.assert_close(ref["x_m"], x_m.transpose(1, 2).double(), rtol=0, atol=1e-5)
    torch.testing.assert_close(ref["logw"], logw.double(), rtol=0, atol=1e-5)
    assert ref["y_lengths"].tolist() == y_len.tolist()

    m = 64
    noise = torch.randn((3, m, cfg["mel_channels"]), generator=torch.Generator().manual_seed(1))
    mel, z_mask = glow_model.expand_and_decode(params, pcfg, x_m, _x_logs, w_ceil, y_len,
                                               mel_max_length=m, noise_scale=0.667, noise=noise)
    y_mask = z_mask.double()[:, None]
    z = (glowtts.expand(ref["x_m"], ref["w_ceil"], m) + noise.transpose(1, 2).double() * 0.667) \
        * y_mask
    want = glowtts.decode(weights.to_dtype(params, torch.float64), cfg, z, y_mask)
    torch.testing.assert_close(want, mel.transpose(1, 2).double(), rtol=0, atol=1e-4)


def test_end_convs_are_live():
    """The departures from the init that keep the coupling and the prenet in
    the output: with the end 1x1s zeroed the mel moves."""
    cfg, params, ids, lengths = _glow()
    p64 = weights.to_dtype(params, torch.float64)
    ref = glowtts.encode(p64, cfg, ids, lengths, 6.0)
    m = 64
    z = glowtts.expand(ref["x_m"], ref["w_ceil"], m)
    y_mask = (torch.arange(m)[None] < ref["y_lengths"][:, None]).double()[:, None]
    live = glowtts.decode(p64, cfg, z * y_mask, y_mask)
    p64["decoder"]["coupling"]["end_w"] = torch.zeros_like(p64["decoder"]["coupling"]["end_w"])
    dead = glowtts.decode(p64, cfg, z * y_mask, y_mask)
    assert float((live - dead).abs().max()) > 1e-3


def _hifi():
    from larynx_tpu_torch.models.hifi_gan import model as hifi_model
    from larynx_tpu_torch.models.hifi_gan.config import HiFiGanConfig

    cfg = tiny_config("hifi_gan")["vocoder"]
    params = hifi_gan.weights(cfg, torch.Generator().manual_seed(4), torch.device("cpu"),
                              torch.float32)
    names = {f.name for f in dataclasses.fields(HiFiGanConfig)}
    pcfg = HiFiGanConfig(**{k: tuple(tuple(x) if isinstance(x, list) else x for x in v)
                            if isinstance(v, list) else v for k, v in cfg.items() if k in names})
    return cfg, params, pcfg, hifi_model


def test_hifigan_matches_the_port():
    cfg, params, pcfg, hifi_model = _hifi()
    mel = torch.randn((2, 20, cfg["num_mels"]), generator=torch.Generator().manual_seed(2))
    got = hifi_model.generator(hifi_model.pack_params(params, pcfg), pcfg, mel)
    want = hifigan.generator(params, cfg, mel.transpose(1, 2))
    torch.testing.assert_close(want, got, rtol=0, atol=2e-5)


def test_waveglow_matches_the_port():
    from larynx_tpu_torch.models.waveglow import model as wg_model
    from larynx_tpu_torch.models.waveglow.config import WaveGlowConfig

    cfg = tiny_config("waveglow")["vocoder"]
    params = waveglow_kind.weights(cfg, torch.Generator().manual_seed(5), torch.device("cpu"),
                                   torch.float32)
    names = {f.name for f in dataclasses.fields(WaveGlowConfig)}
    pcfg = WaveGlowConfig(**{k: v for k, v in cfg.items() if k in names})
    gen = torch.Generator().manual_seed(6)
    mel = torch.randn((2, 6, cfg["mel_channels"]), generator=gen)
    z = 0.9 * torch.randn((2, 6 * cfg["upsample_stride"] // cfg["groups"], cfg["groups"]),
                          generator=gen)
    got = wg_model.infer(wg_model.pack_params(params, pcfg), pcfg, mel, z=z)
    want = waveglow.infer(params, cfg, mel.transpose(1, 2), z.transpose(1, 2))
    torch.testing.assert_close(want, got, rtol=0, atol=1e-5)


def _wg_full(frames=16, seed=9):
    """WaveGlow at the configuration's widths over a short log mel."""
    config = json.loads((HERE / "configs" / "glowtts-harvard.waveglow-256.json").read_text())
    cfg, cpu = config["vocoder"], torch.device("cpu")
    gen = torch.Generator().manual_seed(seed)
    params = waveglow_kind.weights(cfg, gen, cpu, torch.float32)
    mel = torch.clamp(0.5 * torch.randn((1, cfg["mel_channels"], frames), generator=gen), -1, 1)
    mel_pp = rules.postprocess(mel, np.array([frames]), config["audio"])
    prior = waveglow_kind.prior(3, 0, 1, frames, torch.as_tensor([frames]), cfg, cpu)
    return cfg, params, mel_pp, prior


def test_waveglow_couplings_carry_the_signal():
    """With the end 1x1s zero, as the init has them, every coupling is the
    identity; at the drawn ``END_SCALE`` the WN stacks carry the audio, so
    that a WN layer at fault moves it by about its own size."""
    cfg, params, mel_pp, prior = _wg_full()
    live = waveglow_kind.vocode(params, cfg, mel_pp, prior, [0], mel_pp.shape[2])
    for flow in params["flows"]:
        flow["wn"]["end_w"] = torch.zeros_like(flow["wn"]["end_w"])
    dead = waveglow_kind.vocode(params, cfg, mel_pp, prior, [0], mel_pp.shape[2])
    assert float((live - dead).norm() / live.norm()) > 0.5


def test_waveglow_wn_control_rounds_the_wn_alone():
    cfg, params, mel_pp, prior = _wg_full(frames=8)
    exact = waveglow_kind.vocode(params, cfg, mel_pp, prior, [0], 8)
    from portbench.reference.synth import _fp8

    wn = waveglow_kind.vocode(params, cfg, mel_pp, prior, [0], 8, q=_fp8, scope="wn")
    full = waveglow_kind.vocode(params, cfg, mel_pp, prior, [0], 8, q=_fp8, scope="all")
    assert 0 < float((wn - exact).norm()) < float((full - exact).norm())


def test_waveglow_prior_matches_the_port():
    from larynx_tpu_torch.models.waveglow.config import WaveGlowConfig
    from larynx_tpu_torch.runtime.engine import SynthesisEngine

    cfg = tiny_config("waveglow")["vocoder"]
    names = {f.name for f in dataclasses.fields(WaveGlowConfig)}
    eng = SynthesisEngine.__new__(SynthesisEngine)
    eng.seed, eng.device = 3_000_000_011, torch.device("cpu")
    eng.vocoder_cfg = WaveGlowConfig(**{k: v for k, v in cfg.items() if k in names})
    eng.waveglow_sigma = cfg["sigma"]
    valid = torch.as_tensor([40, 17, 0, 64])
    z_mask = (torch.arange(64)[None, :] < valid[:, None]).float()
    want = eng._waveglow_prior(4, 64, z_mask, None, 7)
    got = waveglow_kind.prior(eng.seed, 7, 4, 64, valid, cfg, eng.device)
    assert torch.equal(got, want)


def test_engine_constants_and_buckets_match_the_port():
    from larynx_tpu_torch.runtime import engine
    from larynx_tpu_torch.runtime.buckets import BucketPolicy

    assert rules.MAX_VOCODE_AREA == engine.MAX_VOCODE_AREA
    assert rules.WAVEGLOW_AREA == engine.waveglow_area()
    assert rules.RAMP_MIN_BYTES == engine.RAMP_MIN_BYTES
    assert rules.BUCKET_MARGIN == engine.BUCKET_MARGIN
    assert rules.SILENCE_LOG_MEL == engine.SILENCE_LOG_MEL
    policy = BucketPolicy()
    tables = json.loads((HERE / "traffic" / "batch8.json").read_text())["buckets"]
    assert tuple(tables["text"]) == policy.text_buckets
    assert tuple(tables["mel"]) == policy.mel_buckets
    assert tuple(tables["batch"]) == policy.batch_buckets
    b = rules.Buckets(tables, 2)
    for n in (1, 3, 17, 200, 383, 385, 900):
        assert b.text_bucket(n) == policy.text_bucket(n)
        assert b.batch_bucket(n) == policy.batch_bucket(n)
    for f in (1, 63, 65, 767, 769, 4097, 5000, 9000):
        assert b.mel_bucket(f) == policy.mel_bucket(f)


@pytest.mark.parametrize("upsample,area", [(256, rules.MAX_VOCODE_AREA),
                                           (256, rules.WAVEGLOW_AREA)])
def test_group_plan_matches_the_port(upsample, area):
    import types

    from larynx_tpu_torch.runtime.buckets import BucketPolicy
    from larynx_tpu_torch.runtime.engine import SynthesisEngine

    stub = types.SimpleNamespace(policy=BucketPolicy(), upsample=upsample)
    tables = {"text": BucketPolicy().text_buckets, "mel": BucketPolicy().mel_buckets,
              "batch": BucketPolicy().batch_buckets}
    rng = np.random.default_rng(7)
    for _ in range(200):
        n = int(rng.integers(1, 17))
        lens = np.sort(rng.integers(20, 2600, size=n))[::-1]
        m = BucketPolicy().mel_bucket(int(lens[0]) * int(rng.integers(1, 3)))
        want = SynthesisEngine._ragged_group_plan(stub, lens, n, m, area)
        assert rules.group_plan(rules.Buckets(tables, 2), lens, m, area, upsample) == want


def test_noise_rules_match_the_port():
    from larynx_tpu_torch.runtime.engine import SynthesisEngine

    cfg, params, _ids, _lengths = _glow()
    eng = SynthesisEngine.__new__(SynthesisEngine)
    eng.seed, eng.device = 3_000_000_007, torch.device("cpu")
    gen = eng._noise_generator(None, 5)
    want = torch.randn((2, 70, 80), generator=gen)
    assert torch.equal(rules.batch_noise(eng.seed, 5, (2, 70, 80), eng.device), want)


def test_int16():
    from larynx_tpu_torch.runtime.engine import to_int16

    audio = torch.randn((3, 500), generator=torch.Generator().manual_seed(8)) * 0.3
    n_valid = torch.as_tensor([500, 300, 7])
    assert torch.equal(rules.to_int16(audio, n_valid), to_int16(audio, n_valid))


def test_reference_imports_nothing_of_the_port():
    """The reference, the model kinds it calls and the weights they draw."""
    paths = [*(HERE / "reference").glob("*.py"), *(HERE / "kinds").glob("*.py"),
             HERE / "harness" / "weights.py"]
    for path in sorted(paths):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in ("larynx_tpu_torch", "larynx_tpu", "jax"), \
                    f"{path.name} imports {name}"
