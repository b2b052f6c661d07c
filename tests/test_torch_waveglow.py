"""The port's WaveGlow (params, inference, engine path, text_to_speech) against the JAX package.

Configurations are small (a few flows, narrow WN stacks) with mel 80 and
stride 256 where the engine needs them, and JAX ``init_params`` under a
fixed key with the zero-init coupling end convs perturbed: with
``end_w = 0`` every coupling is the identity and the audio would not
depend on the WN stacks at all.

Tolerances, float32:
  * params: exact (a transpose is a copy).
  * ``infer``: 1e-5 absolute on O(1) audio.  The flows chain 4 WN stacks,
    1x1s and couplings whose scales are exp(-log_s) with |log_s| < 0.5;
    both sides sum the same products in other orders (~1e-7 observed).
  * int16 audio (engine parts, ``text_to_speech``): 2 LSB, as in
    ``tests/test_torch_pipeline.py``; the prior is zero on both sides
    (sigma 0), so they see the same latent.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import larynx_tpu
from larynx_tpu.audio import AudioSettings as JAudioSettings
from larynx_tpu.convert.native import save_params
from larynx_tpu.models.glow_tts import config_from_voice_json
from larynx_tpu.models.glow_tts import init_params as j_glow_init
from larynx_tpu.models.waveglow import WaveGlowConfig as JWaveGlowConfig
from larynx_tpu.models.waveglow import model as jwg
from larynx_tpu.runtime.engine import SynthesisEngine as JEngine
from larynx_tpu.runtime.engine import waveglow_area as j_waveglow_area

import larynx_tpu_torch
from larynx_tpu_torch.audio import AudioSettings
from larynx_tpu_torch.models.glow_tts import config_from_voice_json as t_config_from_voice_json
from larynx_tpu_torch.models.waveglow import WaveGlowConfig
from larynx_tpu_torch.models.waveglow import model as twg
from larynx_tpu_torch.runtime import engine as tengine
from larynx_tpu_torch.waveglow import WaveGlowVocoder
from larynx_tpu_torch.weights import init_params, params_from_jax

from test_torch_pipeline import AUDIO, PHONEME_TABLE, TEXT, VOICE_CONFIG

SMALL = dict(
    mel_channels=8, flows=4, groups=8, early_every=2, early_size=2, wn_kernel_size=3,
    wn_channels=32, wn_layers=3, upsample_kernel=128, upsample_stride=64,
)
# the engine's mels are 80-channel at hop 256
ENGINE = dict(SMALL, mel_channels=80, upsample_kernel=512, upsample_stride=256, wn_layers=2)
VOICE = "en-us_torch_wg_parity-glow_tts"
VOCODER = "waveglow/torch_wg_parity"


def _perturbed_params(cfg, seed):
    """JAX init (numpy leaves) with non-zero coupling end convs."""
    params = jax.tree.map(np.asarray, jwg.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for flow in params["flows"]:
        flow["wn"]["end_w"] = (rng.standard_normal(flow["wn"]["end_w"].shape) * 0.1).astype(np.float32)
    return params


def _port(params_np, cfg):
    return twg.pack_params(params_from_jax(params_np, "waveglow"), cfg)


def test_params_from_jax_layouts():
    cfg = JWaveGlowConfig(**SMALL)
    tree = _perturbed_params(cfg, 0)
    out = params_from_jax(tree, "waveglow")
    # transposed conv [k, Ci, Co] -> [Ci, Co, k]
    np.testing.assert_array_equal(out["upsample"]["w"].numpy(), np.moveaxis(tree["upsample"]["w"], 0, -1))
    np.testing.assert_array_equal(out["upsample"]["b"].numpy(), tree["upsample"]["b"])
    for f_np, f_t in zip(tree["flows"], out["flows"]):
        # the invertible 1x1s are already [Co, Ci]: untouched
        np.testing.assert_array_equal(f_t["convinv"]["w"].numpy(), f_np["convinv"]["w"])
        np.testing.assert_array_equal(f_t["convinv"]["w_inv"].numpy(), f_np["convinv"]["w_inv"])
        wn_np, wn_t = f_np["wn"], f_t["wn"]
        for key in ("start_w", "cond_w", "end_w"):
            np.testing.assert_array_equal(wn_t[key].numpy(), wn_np[key].T)
        for i in range(cfg.wn_layers):
            np.testing.assert_array_equal(wn_t["in_w"][i].numpy(), np.transpose(wn_np["in_w"][i], (2, 1, 0)))
            np.testing.assert_array_equal(wn_t["res_skip_w"][i].numpy(), wn_np["res_skip_w"][i].T)
            np.testing.assert_array_equal(wn_t["in_b"][i].numpy(), wn_np["in_b"][i])
        ch = cfg.wn_channels
        assert tuple(wn_t["res_skip_w"][-1].shape) == (ch, ch)  # the last layer is all skip
        assert tuple(wn_t["cond_w"].shape) == (2 * ch * cfg.wn_layers, cfg.mel_channels * cfg.groups)


def test_pack_params_slices_cond_per_layer():
    """Layer i of a stack reads rows [2ch*i, 2ch*(i+1)) of the cond 1x1."""
    cfg = JWaveGlowConfig(**SMALL)
    tree = _perturbed_params(cfg, 1)
    packed = _port(tree, WaveGlowConfig(**SMALL))
    ch = cfg.wn_channels
    for f_np, f_t in zip(tree["flows"], packed["flows"]):
        for i, layer in enumerate(f_t["wn"]["layers"]):
            cols = slice(2 * ch * i, 2 * ch * (i + 1))
            np.testing.assert_array_equal(layer.w_cond.numpy(), f_np["wn"]["cond_w"][:, cols].T)
            np.testing.assert_allclose(
                layer.bias_a.numpy(), f_np["wn"]["in_b"][i] + f_np["wn"]["cond_b"][cols], rtol=0, atol=0
            )


def test_init_params_matches_jax_shapes():
    cfg = WaveGlowConfig(**SMALL)
    ours = init_params(torch.Generator().manual_seed(0), cfg)
    ref = jax.tree.map(np.asarray, jwg.init_params(jax.random.PRNGKey(0), JWaveGlowConfig(**SMALL)))
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == np.float32
    for flow in ours["flows"]:
        w = flow["convinv"]["w"].astype(np.float64)
        assert np.linalg.det(w) > 0
        np.testing.assert_allclose(w @ flow["convinv"]["w_inv"], np.eye(len(w)), atol=1e-5)
        assert not flow["wn"]["end_w"].any() and not flow["wn"]["end_b"].any()
        assert 0.04 < flow["wn"]["in_w"][0].std() < 0.06


def test_upsample_cond_and_group_audio_match_jax():
    cfg = JWaveGlowConfig(**SMALL)
    tree = _perturbed_params(cfg, 2)
    mel = np.random.default_rng(3).standard_normal((2, 5, cfg.mel_channels)).astype(np.float32)
    ref = jwg._upsample_cond(jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(mel))
    out = twg._upsample_cond(_port(tree, WaveGlowConfig(**SMALL)), WaveGlowConfig(**SMALL),
                             torch.from_numpy(mel))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    audio = np.arange(2 * 83, dtype=np.float32).reshape(2, 83)
    np.testing.assert_array_equal(
        twg._group_audio(torch.from_numpy(audio), 8).numpy(), np.asarray(jwg._group_audio(jnp.asarray(audio), 8))
    )


@pytest.fixture(scope="module")
def infer_problem():
    """``infer``'s problem (perturbed params, mel, prior), the port's audio
    and JAX's audio with identity couplings (end_w = 0): the same for both
    JAX references, so run once."""
    cfg = JWaveGlowConfig(**SMALL)
    tree = _perturbed_params(cfg, 4)
    rng = np.random.default_rng(5)
    m = 6
    mel = rng.standard_normal((2, m, cfg.mel_channels)).astype(np.float32)
    z = (rng.standard_normal((2, m * cfg.upsample_stride // cfg.groups, cfg.groups)) * 0.9).astype(np.float32)
    out = twg.infer(_port(tree, WaveGlowConfig(**SMALL)), WaveGlowConfig(**SMALL),
                    torch.from_numpy(mel), z=torch.from_numpy(z))
    identity_tree = jax.tree.map(np.copy, tree)
    for flow in identity_tree["flows"]:
        flow["wn"]["end_w"] = np.zeros_like(flow["wn"]["end_w"])
    identity = jwg.infer(jax.tree.map(jnp.asarray, identity_tree), cfg, jnp.asarray(mel),
                         z=jnp.asarray(z))
    return tree, mel, z, out, identity


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas_interpret"])
def test_infer_matches_jax(infer_problem, use_pallas):
    cfg = JWaveGlowConfig(**SMALL)
    tree, mel, z, out, identity = infer_problem
    m = mel.shape[1]
    ref = jwg.infer(jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(mel), z=jnp.asarray(z),
                    use_pallas=use_pallas, pallas_interpret=use_pallas)
    assert out.shape == (2, m * cfg.upsample_stride)
    # the WN stacks matter: identity couplings (end_w = 0) give other audio
    assert np.abs(np.asarray(ref) - np.asarray(identity)).max() > 0.1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_infer_draws_the_prior_from_the_generator():
    cfg = WaveGlowConfig(**SMALL)
    params = _port(_perturbed_params(JWaveGlowConfig(**SMALL), 6), cfg)
    mel = torch.zeros((1, 3, cfg.mel_channels))
    draw = lambda seed, sigma=0.9: twg.infer(  # noqa: E731
        params, cfg, mel, generator=torch.Generator().manual_seed(seed), sigma=sigma)
    torch.testing.assert_close(draw(1), draw(1), rtol=0, atol=0)
    assert not torch.equal(draw(1), draw(2))
    z = torch.zeros((1, 3 * cfg.upsample_stride // cfg.groups, cfg.groups))
    torch.testing.assert_close(draw(1, sigma=0.0), twg.infer(params, cfg, mel, z=z), rtol=0, atol=0)


# -----------------------------------------------------------------------------
# Engine and text_to_speech


@pytest.fixture(scope="module")
def engines():
    """The JAX engine and the port's (CPU) on the same small params, sigma 0."""
    glow_cfg = config_from_voice_json(VOICE_CONFIG)
    glow_np = jax.tree.map(np.asarray, j_glow_init(jax.random.PRNGKey(0), glow_cfg))
    voc_np = _perturbed_params(JWaveGlowConfig(**ENGINE), 7)
    ref = JEngine(glow_np, glow_cfg, JAudioSettings(**AUDIO), vocoder_kind="waveglow",
                  vocoder_params=voc_np, vocoder_cfg=JWaveGlowConfig(**ENGINE), waveglow_sigma=0.0)
    port = tengine.SynthesisEngine(
        params_from_jax(glow_np, "glow_tts"), t_config_from_voice_json(VOICE_CONFIG),
        AudioSettings(**AUDIO), vocoder_kind="waveglow",
        vocoder_params=params_from_jax(voc_np, "waveglow"), vocoder_cfg=WaveGlowConfig(**ENGINE),
        waveglow_sigma=0.0, device="cpu",
    )
    return ref, port


def test_waveglow_area_matches_jax():
    assert tengine.waveglow_area() == j_waveglow_area() == tengine.MAX_VOCODE_AREA // 4


@pytest.mark.parametrize("denoise", [0.0, 0.02], ids=["plain", "denoised"])
def test_vocode_launch_groups_and_audio_match_jax(engines, denoise):
    """A ragged batch that the WaveGlow plan splits into several groups:
    same rows per group, same widths, same int16 audio per row."""
    ref, port = engines
    rng = np.random.default_rng(8)
    lens = np.array([300, 40, 290, 150, 35, 30, 28, 26, 25], dtype=np.int64)
    m = 512
    mel = rng.uniform(-1.0, 1.0, size=(len(lens), m, 80)).astype(np.float32)
    mask = (np.arange(m)[None, :] < lens[:, None]).astype(np.float32)
    mel *= mask[..., None]
    sorted_lens = np.sort(lens)[::-1]
    margin = 4 if denoise else 0
    plan = port._ragged_group_plan(sorted_lens, len(lens), m, tengine.waveglow_area(), margin)
    assert plan == ref._ragged_group_plan(sorted_lens, len(lens), m, j_waveglow_area(), margin)
    assert len(plan) >= 2

    ref_parts = ref.vocode_launch(jnp.asarray(mel), jnp.asarray(mask), len(lens), denoise,
                                  jax.random.PRNGKey(0), y_lengths=lens)
    parts = port.vocode_launch(torch.from_numpy(mel), torch.from_numpy(mask), len(lens), denoise,
                               y_lengths=lens)
    assert [idx for _, idx in parts] == [idx for _, idx in ref_parts]
    assert [tuple(p.shape) for p, _ in parts] == [tuple(np.asarray(p).shape) for p, _ in ref_parts]
    for (p, _), (r, _) in zip(parts, ref_parts):
        assert np.abs(p.numpy().astype(np.int32) - np.asarray(r).astype(np.int32)).max() <= 2

    rows = port.vocode_collect(parts, len(lens))
    crops = port.crop_rows(rows, lens, len(lens), denoise)
    ref_crops = ref.crop_rows(ref.vocode_collect(ref_parts, len(lens)), lens, len(lens), denoise)
    assert [len(c) for c in crops] == [len(c) for c in ref_crops]


def test_waveglow_prior_is_seeded_and_masked(engines, monkeypatch):
    """sigma * N(0, 1) from (seed, batch index), zero past each row's frames."""
    _ref, port_sigma = engines
    monkeypatch.setattr(port_sigma, "waveglow_sigma", 0.9)
    mask = torch.zeros((2, 8))
    mask[0, :5] = 1
    mask[1, :3] = 1
    z = port_sigma._waveglow_prior(2, 8, mask, seed=3, batch_index=0)
    per_frame = 256 // 8
    assert z.shape == (2, 8 * per_frame, 8)
    assert z[0, : 5 * per_frame].abs().min() > 0 and not z[0, 5 * per_frame :].any()
    assert not z[1, 3 * per_frame :].any()
    torch.testing.assert_close(z, port_sigma._waveglow_prior(2, 8, mask, seed=3, batch_index=0))
    assert not torch.equal(z, port_sigma._waveglow_prior(2, 8, mask, seed=3, batch_index=1))
    assert not torch.equal(z, port_sigma._waveglow_prior(2, 8, mask, seed=4, batch_index=0))


@pytest.fixture(scope="module")
def voices_dir(tmp_path_factory):
    """A GlowTTS voice and a WaveGlow vocoder dir (config.json with sigma 0)."""
    root = tmp_path_factory.mktemp("torch_wg_voices")
    lang, rest = VOICE.split("_", 1)
    voice_dir = root / lang / rest
    voice_dir.mkdir(parents=True)
    (voice_dir / "config.json").write_text(json.dumps(VOICE_CONFIG), encoding="utf-8")
    (voice_dir / "phonemes.txt").write_text(
        "".join(f"{i} {p}\n" for i, p in enumerate(PHONEME_TABLE)), encoding="utf-8"
    )
    params = jax.tree.map(np.asarray, j_glow_init(jax.random.PRNGKey(0), config_from_voice_json(VOICE_CONFIG)))
    cp = params["decoder"]["coupling"]
    cp["end_w"] = (np.random.default_rng(0).standard_normal(cp["end_w"].shape) * 0.05).astype(np.float32)
    save_params(voice_dir / "generator.npz", params)

    voc_dir = root / VOCODER
    voc_dir.mkdir(parents=True)
    (voc_dir / "config.json").write_text(json.dumps(dict(ENGINE, sigma=0.0)), encoding="utf-8")
    save_params(voc_dir / "generator.npz", _perturbed_params(JWaveGlowConfig(**ENGINE), 9))
    return root


def _synthesize(module, voices_dir, **kwargs):
    extra = {"device": "cpu"} if module is larynx_tpu_torch else {}
    return list(
        module.text_to_speech(
            TEXT, voice_or_lang=VOICE, vocoder_or_quality=VOCODER, custom_voices_dir=voices_dir,
            no_download=True, tts_settings={"noise_scale": 0.0}, **kwargs, **extra,
        )
    )


@pytest.mark.parametrize("denoiser_strength", [0.0, 0.01], ids=["plain", "denoised"])
def test_text_to_speech_waveglow_matches_jax(voices_dir, denoiser_strength):
    ref = _synthesize(larynx_tpu, voices_dir, denoiser_strength=denoiser_strength)
    out = _synthesize(larynx_tpu_torch, voices_dir, denoiser_strength=denoiser_strength)
    assert len(out) == len(ref) == 2
    for r, o in zip(ref, out):
        assert o.text == r.text and o.sample_rate == r.sample_rate
        assert o.audio.dtype == np.int16 and o.audio.shape == r.audio.shape
        assert np.abs(r.audio.astype(np.int32)).max() > 1000
        diff = np.abs(o.audio.astype(np.int32) - r.audio.astype(np.int32)).max()
        assert diff <= 2, f"{diff} LSB apart"


def test_waveglow_vocoder_loads_alias_and_refreshes_inverses(voices_dir, tmp_path):
    vocoder = larynx_tpu_torch.get_vocoder_model(VOCODER, custom_voices_dir=voices_dir, no_download=True)
    assert isinstance(vocoder, WaveGlowVocoder)
    assert vocoder.sigma == 0.0 and vocoder.model_config == WaveGlowConfig(**dict(ENGINE, sigma=0.0))
    # a stale stored inverse is recomputed at load
    tree = _perturbed_params(JWaveGlowConfig(**ENGINE), 9)
    for flow in tree["flows"]:
        flow["convinv"]["w_inv"] = np.zeros_like(flow["convinv"]["w_inv"])
    model_dir = tmp_path / "waveglow" / "wn_256"
    model_dir.mkdir(parents=True)
    (model_dir / "config.json").write_text(json.dumps(ENGINE), encoding="utf-8")
    save_params(model_dir / "generator.npz", tree)
    loaded = larynx_tpu_torch.get_vocoder_model("waveglow", custom_voices_dir=tmp_path, no_download=True)
    assert loaded.sigma == 0.9
    for flow in loaded.params["flows"]:
        w, w_inv = flow["convinv"]["w"], flow["convinv"]["w_inv"]
        torch.testing.assert_close(w @ w_inv, torch.eye(w.shape[0]), atol=1e-5, rtol=0)
