"""Multi-speaker GlowTTS in the port against the JAX package, on CPU.

The geometry of ``tests/test_multispeaker.py`` (4 speakers, gin_channels 32,
hidden 64, 2 encoder layers, 2 flow blocks of 2 WN layers) with JAX
``init_params`` under a fixed key; the zero-initialised coupling end
projection and actnorm are filled with small random values, so the speaker
conditioning reaches the mel through every coupling.  The same numpy params
and inputs go through both packages: the models, the engine (with the small
HiFi-GAN of ``tests/test_torch_pipeline.py``), the stream, the per-model
``phonemes_to_mels`` and the unfused fallback.

Tolerances:
  * models in float32 (speaker embedding, encode with ``g``,
    ``expand_and_decode`` with ``g`` at an injected latent, mels of
    ``phonemes_to_mels``): 1e-5 absolute.  The outputs are O(1) and pass
    through a few tens of dependent f32 reductions whose order differs
    between XLA and torch on the CPU (~1e-6 observed); the durations that
    set the lengths are compared exactly.
  * int16 audio: 2 LSB per sample, as ``tests/test_torch_pipeline.py``.
  * bfloat16 (``half``): the JAX package's bar, correlation > 0.999 and RMS
    within 1% of the reference's peak, at the JAX side's durations with the
    latent injected, as ``tests/test_torch_mixed_precision.py``.
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
from larynx_tpu.glow_tts import GlowTextToSpeech as JGlowTextToSpeech
from larynx_tpu.models.glow_tts import config_from_voice_json as j_config
from larynx_tpu.models.glow_tts import model as j_glow
from larynx_tpu.models.hifi_gan import hifi_gan_config_from_json as j_hifi_config
from larynx_tpu.models.hifi_gan import init_params as j_hifi_init
from larynx_tpu.runtime.engine import SynthesisEngine as JEngine

import larynx_tpu_torch
from larynx_tpu_torch import weights
from larynx_tpu_torch.audio import AudioSettings
from larynx_tpu_torch.glow_tts import GlowTextToSpeech
from larynx_tpu_torch.models.glow_tts import config_from_voice_json as t_config
from larynx_tpu_torch.models.glow_tts import model as t_glow
from larynx_tpu_torch.models.hifi_gan import hifi_gan_config_from_json as t_hifi_config
from larynx_tpu_torch.runtime import engine as tengine

from test_torch_pipeline import AUDIO, PHONEME_TABLE, VOCODER, VOCODER_CONFIG

ATOL = 1e-5
LSB = 2
CORRELATION = 0.999
N_SPEAKERS = 4
VOICE = "en-us_torch_multispeaker-glow_tts"
VOICE_CONFIG = {
    "audio": AUDIO,
    "model": {
        "num_symbols": 46, "hidden_channels": 64, "filter_channels": 128,
        "filter_channels_dp": 64, "kernel_size": 3, "n_blocks_dec": 2, "n_layers_enc": 2,
        "n_heads": 2, "kernel_size_dec": 5, "dilation_rate": 1, "n_block_layers": 2,
        "n_sqz": 2, "prenet": True, "mean_only": True, "window_size": 4,
        "n_speakers": N_SPEAKERS, "gin_channels": 32, "n_split": 4,
    },
}
TEXT = "The birch canoe slid on the smooth planks."


def _glow_params(seed: int = 0):
    """JAX init params (numpy) with the zero-init coupling end and actnorm
    made random."""
    params = jax.tree.map(np.asarray, j_glow.init_params(jax.random.PRNGKey(seed),
                                                         j_config(VOICE_CONFIG)))
    rng = np.random.default_rng(seed)
    cp = params["decoder"]["coupling"]
    cp["end_w"] = (rng.standard_normal(cp["end_w"].shape) * 0.05).astype(np.float32)
    cp["end_b"] = (rng.standard_normal(cp["end_b"].shape) * 0.05).astype(np.float32)
    an = params["decoder"]["actnorm"]
    an["logs"] = (rng.standard_normal(an["logs"].shape) * 0.1).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def models():
    glow_np = _glow_params()
    voc_np = jax.tree.map(np.asarray, j_hifi_init(jax.random.PRNGKey(1),
                                                  j_hifi_config(VOCODER_CONFIG)))
    return glow_np, voc_np


def _jax_engine(models, **kwargs):
    glow_np, voc_np = models
    return JEngine(glow_np, j_config(VOICE_CONFIG), JAudioSettings(**AUDIO),
                   vocoder_kind="hifi_gan", vocoder_params=voc_np,
                   vocoder_cfg=j_hifi_config(VOCODER_CONFIG), **kwargs)


def _port_engine(models, **kwargs):
    glow_np, voc_np = models
    return tengine.SynthesisEngine(
        weights.params_from_jax(glow_np, "glow_tts"), t_config(VOICE_CONFIG),
        AudioSettings(**AUDIO), vocoder_params=weights.params_from_jax(voc_np, "hifi_gan"),
        vocoder_cfg=t_hifi_config(VOCODER_CONFIG), device="cpu", **kwargs)


@pytest.fixture(scope="module")
def engines(models):
    return _jax_engine(models), _port_engine(models)


def _lsb(a, b) -> int:
    assert a.dtype == b.dtype == np.int16 and a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def _ids(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 46, size=n).astype(np.int64) for n in lengths]


# -----------------------------------------------------------------------------
# Params


def test_params_from_jax_converts_speaker_params(models):
    """emb_g keeps its layout; each coupling's cond 1x1 [1, gin, 2h*L]
    becomes [1, 2h*L, gin], as the other 1x1s are transposed."""
    glow_np, _ = models
    tparams = weights.params_from_jax(glow_np, "glow_tts")
    np.testing.assert_array_equal(tparams["emb_g"].numpy(), glow_np["emb_g"])
    wn, twn = glow_np["decoder"]["coupling"]["wn"], tparams["decoder"]["coupling"]["wn"]
    assert wn["cond_w"].shape == (2, 1, 32, 2 * 64 * 2)
    np.testing.assert_array_equal(twn["cond_w"].numpy(), np.swapaxes(wn["cond_w"], -2, -1))
    np.testing.assert_array_equal(twn["cond_b"].numpy(), wn["cond_b"])


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tuple(np.shape(tree))}


def test_init_params_has_the_jax_tree(models):
    """weights.init_params draws a multi-speaker tree with the JAX
    init_params' leaves and shapes: emb_g uniform in +-0.1, the cond 1x1
    inside 1/sqrt(gin)."""
    glow_np, _ = models
    tree = weights.init_params(torch.Generator().manual_seed(0), t_config(VOICE_CONFIG))
    assert _shapes(tree) == _shapes(glow_np)
    assert 0.0 < np.abs(tree["emb_g"]).max() <= 0.1
    bound = 1.0 / np.sqrt(32)
    cond = tree["decoder"]["coupling"]["wn"]
    assert 0.0 < np.abs(cond["cond_w"]).max() <= bound
    assert 0.0 < np.abs(cond["cond_b"]).max() <= bound


# -----------------------------------------------------------------------------
# Models


def test_speaker_embedding_matches_jax(models):
    glow_np, _ = models
    speakers = np.array([2, 0, 3, 1])
    ref = np.asarray(j_glow.speaker_embedding(glow_np, jnp.asarray(speakers)))
    out = t_glow.speaker_embedding(weights.params_from_jax(glow_np, "glow_tts"),
                                   torch.from_numpy(speakers)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-6)


def _encode_both(models, speakers, ids, lengths, length_scale=1.5):
    glow_np, _ = models
    jcfg, tcfg = j_config(VOICE_CONFIG), t_config(VOICE_CONFIG)
    tparams = weights.params_from_jax(glow_np, "glow_tts")
    g_ref = j_glow.speaker_embedding(glow_np, jnp.asarray(speakers))
    ref = j_glow.encode(glow_np, jcfg, jnp.asarray(ids), jnp.asarray(lengths), length_scale,
                        g=g_ref)
    g = t_glow.speaker_embedding(tparams, torch.from_numpy(speakers))
    out = t_glow.encode(tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(lengths),
                        length_scale, g=g)
    return ref, out, g_ref, g, tparams


def test_encode_with_speaker_matches_jax(models):
    """g [B, gin] broadcast over T into the duration predictor's input: the
    same log-durations, the same ceil'd durations and lengths."""
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 46, size=(3, 16)).astype(np.int64)
    lengths = np.array([16, 11, 5], dtype=np.int64)
    ref, out, _g_ref, _g, _ = _encode_both(models, np.array([3, 1, 0]), ids, lengths)
    for name, r, o in zip(("x_m", "x_logs", "logw"), ref[:3], out[:3]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL, rtol=0, err_msg=name)
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(out[4].numpy(), np.asarray(ref[4]))
    # the speaker moves the durations: the conditioning is live
    other = _encode_both(models, np.array([2, 2, 2]), ids, lengths)[1]
    assert not np.allclose(other[2].numpy(), out[2].numpy())


def test_expand_and_decode_with_speaker_matches_jax(models):
    """The reverse flow with each coupling's cond 1x1 slice added before
    the gate, at the noise jax.random draws for the JAX side."""
    rng = np.random.default_rng(4)
    ids = rng.integers(1, 46, size=(2, 16)).astype(np.int64)
    lengths = np.array([16, 9], dtype=np.int64)
    speakers = np.array([1, 3])
    ref_enc, _out_enc, g_ref, g, tparams = _encode_both(models, speakers, ids, lengths)
    glow_np, _ = models
    x_m, x_logs, _logw, w_ceil, y_lengths, _mask = ref_enc
    mel_max = int(-(-int(np.asarray(y_lengths).max()) // 32) * 32) + 32
    key = jax.random.PRNGKey(7)
    ref_mel, ref_mask = j_glow.expand_and_decode(
        glow_np, j_config(VOICE_CONFIG), x_m, x_logs, w_ceil, y_lengths, key, mel_max,
        np.float32(0.667), g=g_ref)
    noise = np.array(jax.random.normal(key, (2, mel_max, 80), dtype=jnp.float32))
    tt = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    mel, z_mask = t_glow.expand_and_decode(
        tparams, t_config(VOICE_CONFIG), tt(x_m), tt(x_logs), tt(w_ceil), tt(y_lengths),
        mel_max, noise_scale=0.667, noise=torch.from_numpy(noise), g=g)
    np.testing.assert_array_equal(z_mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_allclose(mel.numpy(), np.asarray(ref_mel), atol=ATOL, rtol=0)
    # another speaker gives another mel at the same latent and durations
    other, _ = t_glow.expand_and_decode(
        tparams, t_config(VOICE_CONFIG), tt(x_m), tt(x_logs), tt(w_ceil), tt(y_lengths),
        mel_max, noise_scale=0.667, noise=torch.from_numpy(noise),
        g=t_glow.speaker_embedding(tparams, torch.tensor([0, 0])))
    assert np.abs(other.numpy() - mel.numpy()).max() > 1e-3


def test_half_with_speaker_matches_jax(models):
    """bf16 (``half``): encode and the reverse flow with a speaker against
    the JAX package's bf16 run, at the JAX side's durations with the latent
    injected, by the end-to-end bar."""
    glow_np, _ = models
    jcfg, tcfg = j_config(VOICE_CONFIG), t_config(VOICE_CONFIG)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), glow_np)
    tparams = weights.cast(weights.params_from_jax(glow_np, "glow_tts"), torch.bfloat16)
    rng = np.random.default_rng(12)
    ids = rng.integers(1, 46, size=(2, 30)).astype(np.int64)
    lengths = np.array([30, 21], dtype=np.int64)
    speakers = np.array([3, 1])
    g_ref = j_glow.speaker_embedding(jparams, jnp.asarray(speakers))
    g = t_glow.speaker_embedding(tparams, torch.from_numpy(speakers))
    assert g.dtype == torch.bfloat16
    j_enc = j_glow.encode(jparams, jcfg, jnp.asarray(ids), jnp.asarray(lengths), 1.0, g=g_ref)
    t_enc = t_glow.encode(tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(lengths), 1.0,
                          g=g)
    corr = lambda a, b: float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])  # noqa: E731
    f32 = lambda a: np.array(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
    assert corr(t_enc[2].float().numpy(), f32(j_enc[2])) > CORRELATION  # logw

    x_m, x_logs, _logw, w_ceil, y_lengths, _mask = j_enc
    m = int(-(-int(np.asarray(y_lengths).max()) // 8) * 8)
    noise = rng.standard_normal((2, m, 80)).astype(np.float32)
    real = jax.random.normal
    jax.random.normal = lambda k, shape, dtype=jnp.float32: jnp.asarray(noise, dtype)
    try:
        ref, _ = j_glow.expand_and_decode(jparams, jcfg, x_m, x_logs, w_ceil, y_lengths,
                                          jax.random.PRNGKey(0), mel_max_length=m,
                                          noise_scale=0.667, g=g_ref)
    finally:
        jax.random.normal = real
    tt = lambda a: torch.from_numpy(f32(a))  # noqa: E731
    out, _ = t_glow.expand_and_decode(
        tparams, tcfg, tt(x_m).to(torch.bfloat16), tt(x_logs).to(torch.bfloat16), tt(w_ceil),
        torch.from_numpy(np.asarray(y_lengths)), m, noise_scale=0.667,
        noise=torch.from_numpy(noise), g=g)
    ref = f32(ref)
    assert out.dtype == torch.bfloat16
    assert corr(out.float().numpy(), ref) > CORRELATION
    rms = lambda a: float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))  # noqa: E731
    assert abs(rms(out.float().numpy()) - rms(ref)) < 0.01 * np.abs(ref).max()


# -----------------------------------------------------------------------------
# Engine


def test_engine_synthesize_batch_with_speakers_matches_jax(engines):
    """synthesize_batch(speaker_ids=) at noise 0: same lengths, <= 2 LSB."""
    ref_engine, port = engines
    ids = _ids(5, (24, 17, 30))
    speakers = [3, 0, 2]
    ref = ref_engine.synthesize_batch(ids, noise_scale=0.0, length_scale=1.5,
                                      speaker_ids=speakers)
    out = port.synthesize_batch(ids, noise_scale=0.0, length_scale=1.5, speaker_ids=speakers)
    assert len(out) == len(ref) == 3
    for r, o in zip(ref, out):
        assert np.abs(r.astype(np.int32)).max() > 1000
        assert _lsb(o, r) <= LSB
    # one sentence, two speakers: two voices
    a = port.synthesize_batch(ids[:1], noise_scale=0.0, speaker_ids=[1])[0]
    b = port.synthesize_batch(ids[:1], noise_scale=0.0, speaker_ids=[2])[0]
    assert a.shape != b.shape or _lsb(a, b) > 1000


def test_engine_stream_with_speaker_matches_jax(engines):
    """synthesize_stream(speaker_ids=[k]) chunk for chunk against the JAX
    stream at noise 0."""
    ref_engine, port = engines
    ids = _ids(6, (40,))[0]
    kwargs = dict(noise_scale=0.0, length_scale=2.0, chunk_frames=32, speaker_ids=[2])
    ref = list(ref_engine.synthesize_stream(ids, **kwargs))
    out = list(port.synthesize_stream(ids, **kwargs))
    assert len(out) == len(ref) > 1
    for r, o in zip(ref, out):
        assert _lsb(o, r) <= LSB


def test_engine_phonemes_to_mels_with_speaker_matches_jax(engines):
    ref_engine, port = engines
    ids = _ids(7, (21,))[0]
    for speaker in (0, 3):
        ref = ref_engine.phonemes_to_mels(ids, noise_scale=0.0, speaker_id=speaker)
        out = port.phonemes_to_mels(ids, noise_scale=0.0, speaker_id=speaker)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_missing_or_unknown_speaker_raises(engines):
    """A multi-speaker voice needs a speaker id: a ValueError that says so,
    not a shape error inside the duration predictor; an id outside the
    voice's speakers raises too."""
    _ref, port = engines
    ids = _ids(8, (12,))
    with pytest.raises(ValueError, match="speaker"):
        port.encode_launch(ids)
    with pytest.raises(ValueError, match="speaker"):
        port.synthesize_batch(ids, noise_scale=0.0)
    with pytest.raises(ValueError, match="speaker"):
        port.phonemes_to_mels(ids[0])
    with pytest.raises(ValueError, match="outside"):
        port.encode_launch(ids, speaker_ids=[N_SPEAKERS])


# -----------------------------------------------------------------------------
# The per-model surface, the fallback and the library


@pytest.fixture(scope="module")
def voices_dir(tmp_path_factory, models):
    glow_np, voc_np = models
    root = tmp_path_factory.mktemp("torch_multispeaker_voices")
    lang, rest = VOICE.split("_", 1)
    voice_dir = root / lang / rest
    voice_dir.mkdir(parents=True)
    (voice_dir / "config.json").write_text(json.dumps(VOICE_CONFIG), encoding="utf-8")
    (voice_dir / "phonemes.txt").write_text(
        "".join(f"{i} {p}\n" for i, p in enumerate(PHONEME_TABLE)), encoding="utf-8")
    save_params(voice_dir / "generator.npz", glow_np)
    voc_dir = root / VOCODER
    voc_dir.mkdir(parents=True)
    (voc_dir / "config.json").write_text(json.dumps(VOCODER_CONFIG), encoding="utf-8")
    save_params(voc_dir / "generator.npz", voc_np)
    return root


def _clear_caches():
    for module in (larynx_tpu, larynx_tpu_torch):
        module._TTS_MODEL_CACHE.clear()
        module._VOCODER_MODEL_CACHE.clear()
        module._ENGINE_CACHE.clear()


def test_phonemes_to_mels_surface_carries_speaker_id(voices_dir, engines):
    """GlowTextToSpeech.phonemes_to_mels reads settings["speaker_id"], as
    the JAX model does, and agrees with the engine's phonemes_to_mels."""
    from larynx_tpu.constants import TextToSpeechModelConfig

    voice_dir = voices_dir / "en-us" / VOICE.split("_", 1)[1]
    port_model = GlowTextToSpeech(voice_dir)
    ref_model = JGlowTextToSpeech(TextToSpeechModelConfig(model_path=voice_dir))
    ids = _ids(9, (18,))[0]
    for speaker in (1, 2):
        settings = {"noise_scale": 0.0, "speaker_id": speaker}
        out = port_model.phonemes_to_mels(ids, settings=settings, device="cpu")
        np.testing.assert_allclose(out, ref_model.phonemes_to_mels(ids, settings=settings),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(
            out, engines[1].phonemes_to_mels(ids, noise_scale=0.0, speaker_id=speaker),
            atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="speaker"):
        port_model.phonemes_to_mels(ids, settings={"noise_scale": 0.0}, device="cpu")


def test_fallback_with_speaker_matches_jax(voices_dir):
    """The unfused fallback carries tts_settings' speaker_id into the
    model's phonemes_to_mels in both packages: <= 2 LSB."""
    _clear_caches()
    try:
        settings = {"noise_scale": 0.0, "speaker_id": 3}
        kwargs = dict(custom_voices_dir=voices_dir, no_download=True)
        j_job = larynx_tpu._build_jobs(TEXT, VOICE, VOCODER, **kwargs)[0]
        t_job = larynx_tpu_torch._build_jobs(TEXT, VOICE, VOCODER, **kwargs)[0]
        ref = larynx_tpu._sentence_task_fallback(j_job, settings, None)
        out = larynx_tpu_torch._sentence_task_fallback(t_job, settings, None, "cpu")
        assert np.abs(ref.astype(np.int32)).max() > 1000
        assert _lsb(out, ref) <= LSB
    finally:
        _clear_caches()


def test_text_to_speech_on_a_multispeaker_voice_raises(voices_dir):
    """text_to_speech passes no speaker id (neither package does), so a
    multi-speaker voice raises the engine's ValueError."""
    _clear_caches()
    try:
        with pytest.raises(ValueError, match="speaker"):
            list(larynx_tpu_torch.text_to_speech(
                TEXT, voice_or_lang=VOICE, vocoder_or_quality=VOCODER,
                custom_voices_dir=voices_dir, no_download=True, device="cpu"))
    finally:
        _clear_caches()
