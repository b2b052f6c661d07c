"""The port's per-model surface, unfused fallback and Griffin-Lim engine
against ``larynx_tpu``, on CPU.

``GlowTextToSpeech.phonemes_to_mels``, ``HiFiGanVocoder.mels_to_audio``
(with and without the denoiser), ``WaveGlowVocoder.mels_to_audio`` (bucketed
and chunked), the engine's batched Griffin-Lim vocode, and the library
calls that reach them: ``stream_text_to_speech`` with WaveGlow and with
Griffin-Lim (one chunk per sentence through the fallback), and
``text_to_speech`` with Griffin-Lim and through the fallback.  The voice of
``tests/test_torch_pipeline.py`` (HiFi-GAN ``hifi_gan/torch_port_parity``)
plus a small WaveGlow with sigma 0 (zero prior on both sides), GlowTTS at
noise 0, so both packages see the same latent.  Griffin-Lim runs on a copy
of the voice whose ``spec_gain`` is 20: the random weights' normalised mels
fill the clip range [-1, 1], which ``spec_gain`` 1 maps to amplitudes up to
1e20, and their squares overflow float32 in both packages (a trained voice
stays far below); at 20 the amplitudes stay under 10.

Tolerances:
  * mels: 1e-4 absolute, as ``tests/test_torch_glow_tts.py``;
  * int16 audio through a neural vocoder: 2 LSB, as
    ``tests/test_torch_pipeline.py``;
  * int16 audio through Griffin-Lim, both sides at one injected initial
    phase (``jax.random`` bits cannot be drawn by torch): 1e-3 relative L2
    error.  Sixty chained projections carry the FFTs' float32 rounding
    along, most in the bins whose magnitude is near 0 (their phase X/|X|
    is ill-conditioned), so the largest sample difference grows with the
    iteration count (to 16 LSB at momentum 0.99 on the engine's batch
    here) while the L2 error stays at ~2e-5 (momentum 0.99) and ~1e-6
    (momentum 0) before int16 rounding, which adds ~1e-4.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import larynx_tpu
import larynx_tpu.dsp.stft as jdsp
import larynx_tpu.models.griffin_lim as jgl
import larynx_tpu.runtime.engine as jengine
from larynx_tpu.audio import AudioSettings as JAudioSettings
from larynx_tpu.constants import VocoderType as JVocoderType
from larynx_tpu.convert.native import save_params
from larynx_tpu.models.glow_tts import config_from_voice_json
from larynx_tpu.models.glow_tts import init_params as j_glow_init
from larynx_tpu.models.waveglow import WaveGlowConfig as JWaveGlowConfig

import larynx_tpu_torch
import larynx_tpu_torch.dsp.stft as tdsp
import larynx_tpu_torch.models.griffin_lim as tgl
from larynx_tpu_torch.audio import AudioSettings
from larynx_tpu_torch.constants import VocoderType
from larynx_tpu_torch.models.glow_tts import config_from_voice_json as t_config_from_voice_json
from larynx_tpu_torch.runtime import engine as tengine
from larynx_tpu_torch.runtime.scheduler import BatchScheduler
from larynx_tpu_torch.weights import params_from_jax

from test_torch_pipeline import AUDIO, TEXT, VOCODER, VOICE, VOICE_CONFIG, voices_dir  # noqa: F401
from test_torch_waveglow import ENGINE, _perturbed_params

MEL_ATOL = 1e-4
LSB = 2
GL_REL = 1e-3
WAVEGLOW = "waveglow/torch_fallback_parity"
GL_VOICE = "en-us_torch_gl_parity-glow_tts"


def _clear_caches():
    for module in (larynx_tpu, larynx_tpu_torch):
        module._TTS_MODEL_CACHE.clear()
        module._VOCODER_MODEL_CACHE.clear()
        module._ENGINE_CACHE.clear()


@pytest.fixture(scope="module")
def voices(voices_dir):  # noqa: F811
    """The pipeline tests' voices dir plus a small WaveGlow (sigma 0) and
    the voice at spec_gain 20 for Griffin-Lim."""
    lang, rest = VOICE.split("_", 1)
    gl_dir = voices_dir / lang / GL_VOICE.split("_", 1)[1]
    gl_dir.mkdir()
    config = json.loads((voices_dir / lang / rest / "config.json").read_text(encoding="utf-8"))
    config["audio"]["spec_gain"] = 20.0
    (gl_dir / "config.json").write_text(json.dumps(config), encoding="utf-8")
    for name in ("phonemes.txt", "generator.npz"):
        (gl_dir / name).symlink_to(voices_dir / lang / rest / name)
    wg_dir = voices_dir / WAVEGLOW
    wg_dir.mkdir(parents=True)
    (wg_dir / "config.json").write_text(json.dumps(dict(ENGINE, sigma=0.0)), encoding="utf-8")
    save_params(wg_dir / "generator.npz", _perturbed_params(JWaveGlowConfig(**ENGINE), 9))
    _clear_caches()
    yield voices_dir
    _clear_caches()


def _lsb(a, b) -> int:
    assert a.dtype == b.dtype == np.int16 and a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def _gl_close(a, b) -> float:
    """Relative L2 error of int16 audio a against b (same shape, not silent)."""
    assert a.dtype == b.dtype == np.int16 and a.shape == b.shape, (a.shape, b.shape)
    a, b = a.astype(np.float64), b.astype(np.float64)
    assert np.abs(b).max() > 1000
    err = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    assert err < GL_REL, err
    return err


def _phase_for(shape) -> np.ndarray:
    """One initial phase per spectrogram shape, from a seed of that shape."""
    rng = np.random.default_rng(int(np.prod(shape)))
    return rng.uniform(0, 2 * np.pi, tuple(shape)).astype(np.float32)


@pytest.fixture
def injected_phase(monkeypatch):
    """Griffin-Lim in both packages starts from ``_phase_for`` its
    magnitudes' shape: in the engines (``dsp.stft.griffin_lim``) and in
    the vocoder wrappers (``models.griffin_lim.mels_to_audio``).  Engines
    are built afresh, so the JAX ones trace the patched function."""
    j_loop, t_loop = jdsp.griffin_lim, tdsp.griffin_lim

    def j_griffin_lim(mag, key, fft, hop, n_iters, initial_phase=None, momentum=0.0):
        return j_loop(mag, None, fft, hop, n_iters,
                      initial_phase=jnp.asarray(_phase_for(mag.shape)), momentum=momentum)

    def t_griffin_lim(mag, generator, fft, hop, n_iters, initial_phase=None, momentum=0.0):
        phase = torch.from_numpy(_phase_for(mag.shape)).to(mag.device)
        return t_loop(mag, None, fft, hop, n_iters, initial_phase=phase, momentum=momentum)

    j_model, t_model = jgl.mels_to_audio, tgl.mels_to_audio

    def j_mels_to_audio(mels, basis, key=None, **kwargs):
        shape = (mels.shape[0], basis.shape[1], mels.shape[2] - 1)
        return j_model(mels, basis, initial_phase=jnp.asarray(_phase_for(shape)), **kwargs)

    def t_mels_to_audio(mels, basis, generator=None, **kwargs):
        shape = (mels.shape[0], basis.shape[1], mels.shape[2] - 1)
        return t_model(mels, basis, initial_phase=torch.from_numpy(_phase_for(shape)), **kwargs)

    monkeypatch.setattr(jdsp, "griffin_lim", j_griffin_lim)
    monkeypatch.setattr(tdsp, "griffin_lim", t_griffin_lim)
    monkeypatch.setattr(jgl, "mels_to_audio", j_mels_to_audio)
    monkeypatch.setattr(tgl, "mels_to_audio", t_mels_to_audio)
    _clear_caches()
    yield
    _clear_caches()


def _models(voices, package, vocoder=VOCODER):
    tts = package.get_tts_model(VOICE, custom_voices_dir=voices, no_download=True)
    voc = package.get_vocoder_model(vocoder, custom_voices_dir=voices, no_download=True)
    return tts, voc


def _ids(voices):
    jobs = larynx_tpu_torch._build_jobs(TEXT, VOICE, VOCODER, custom_voices_dir=voices,
                                        no_download=True)
    return [job["ids"] for job in jobs]


# -----------------------------------------------------------------------------
# Per-model surfaces


def test_phonemes_to_mels_matches_jax(voices):
    j_tts, _ = _models(voices, larynx_tpu)
    t_tts, _ = _models(voices, larynx_tpu_torch)
    for ids in _ids(voices):
        for settings in ({"noise_scale": 0.0}, {"noise_scale": 0.0, "length_scale": 1.5}):
            ref = j_tts.phonemes_to_mels(ids, settings=settings)
            out = t_tts.phonemes_to_mels(ids[None], settings=settings, device="cpu")
            assert out.dtype == np.float32 and out.shape == ref.shape
            assert out.shape[:2] == (1, 80) and out.shape[2] > 20
            np.testing.assert_allclose(out, ref, atol=MEL_ATOL, rtol=0)


def _postprocessed_mel(seed, frames):
    """A dynamic-range-compressed mel [1, 80, frames] of speech-like level."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-7.0, 1.0, size=(1, 80, frames)).astype(np.float32)


@pytest.mark.parametrize("strength", [0.0, 0.01], ids=["plain", "denoised"])
def test_hifi_gan_mels_to_audio_matches_jax(voices, strength):
    """The model's default strength as load_vocoder_model(denoiser_strength=)
    sets it, and a settings override back to none; 90 frames pad to the
    128-frame bucket."""
    path = voices / VOCODER
    ref_model = larynx_tpu.load_vocoder_model(JVocoderType.HIFI_GAN, path,
                                              denoiser_strength=strength)
    model = larynx_tpu_torch.load_vocoder_model(VocoderType.HIFI_GAN, path,
                                                denoiser_strength=strength)
    mel = _postprocessed_mel(1, 90)
    for settings in (None, {"denoiser_strength": 0.0}):
        ref = ref_model.mels_to_audio(mel, settings=settings)
        out = model.mels_to_audio(mel, settings=settings, device="cpu")
        denoised = strength > 0 and settings is None
        n = tdsp.num_frames(90 * 256, 1024, 256) * 256 + 1024 if denoised else 90 * 256
        assert out.shape == (n,) and np.abs(out.astype(np.int32)).max() > 1000
        assert _lsb(out, ref) <= LSB
    assert model.maybe_init_denoiser("cpu") is model.maybe_init_denoiser("cpu")  # built once


@pytest.fixture(scope="module")
def waveglow_whole(voices):
    """The port's WaveGlow audio of the 300-frame mel in one bucketed call:
    the bucketed case's output and the chunked case's reference, run once."""
    model = larynx_tpu_torch.load_vocoder_model(VocoderType.WAVEGLOW, voices / WAVEGLOW)
    return model.mels_to_audio(_postprocessed_mel(2, 300), device="cpu")


@pytest.mark.parametrize("mode", ["bucketed", "chunked"])
def test_waveglow_mels_to_audio_matches_jax(voices, waveglow_whole, mode, monkeypatch):
    """Bucketed, and chunked when MAX_VOCODE_AREA (set in both engines, as
    LARYNX_TPU_MAX_VOCODE_AREA would at import) caps a call at 256 frames:
    300 frames in two haloed chunks, whose samples are also the port's
    unchunked call's."""
    path = voices / WAVEGLOW
    ref_model = larynx_tpu.load_vocoder_model(JVocoderType.WAVEGLOW, path)
    model = larynx_tpu_torch.load_vocoder_model(VocoderType.WAVEGLOW, path)
    frames = 300
    mel = _postprocessed_mel(2, frames)
    if mode == "chunked":
        monkeypatch.setattr(jengine, "MAX_VOCODE_AREA", 1024)
        monkeypatch.setattr(tengine, "MAX_VOCODE_AREA", 1024)
        calls = []
        generate = model._generate
        monkeypatch.setattr(model, "_generate",
                            lambda m, z, d: calls.append(m.shape[-1]) or generate(m, z, d))
    ref = ref_model.mels_to_audio(mel)
    out = model.mels_to_audio(mel, device="cpu") if mode == "chunked" else waveglow_whole
    assert out.shape == (frames * 256,) and np.abs(out.astype(np.int32)).max() > 1000
    assert _lsb(out, ref) <= LSB
    if mode == "chunked":
        halo = model._halo_frames()
        assert calls == [model.policy.mel_bucket(256 + halo), model.policy.mel_bucket(44 + halo)]
        assert _lsb(out, waveglow_whole) <= LSB


def test_waveglow_chunked_prior_is_one_draw(voices):
    """With a prior (sigma 0.9) each chunk takes its slice of one draw, so
    the chunks join into the unchunked call at the same draw; a draw per
    chunk would jump at every seam."""
    model = larynx_tpu_torch.load_vocoder_model(VocoderType.WAVEGLOW, voices / WAVEGLOW)
    mel = _postprocessed_mel(3, 300)
    z = 0.9 * torch.randn((1, 512 * 32, 8), generator=torch.Generator().manual_seed(4))
    cpu = torch.device("cpu")
    with torch.inference_mode():
        chunked = model._vocode_chunked(mel, 128, cpu, torch.float32, z_full=z)
        padded = np.concatenate([mel, np.full((1, 80, 84), np.log(1e-5), np.float32)], -1)
        whole = model._generate(torch.from_numpy(padded), z[:, : 384 * 32], torch.float32)
    assert chunked.shape == (1, 300 * 256)
    torch.testing.assert_close(chunked, whole[:, : 300 * 256], rtol=0, atol=1e-5)


def test_the_env_var_sets_max_vocode_area():
    code = "from larynx_tpu_torch.runtime import engine; print(engine.MAX_VOCODE_AREA)"
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=Path(__file__).resolve().parent.parent, timeout=120,
                          env=dict(os.environ, LARYNX_TPU_MAX_VOCODE_AREA="2048"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "2048"


# -----------------------------------------------------------------------------
# Griffin-Lim in the engine


@pytest.fixture(scope="module")
def glow_np():
    """The voice's GlowTTS params (JAX init, key 0) as numpy, built once for
    the engines of the Griffin-Lim tests."""
    return jax.tree.map(np.asarray, j_glow_init(jax.random.PRNGKey(0),
                                                config_from_voice_json(VOICE_CONFIG)))


@pytest.mark.parametrize("momentum", [0.0, 0.99], ids=["plain", "fast"])
def test_engine_griffin_lim_vocode_matches_jax(injected_phase, glow_np, momentum):
    """A padded batch of three rows, vocoded whole; crops of (y - 1) hops + fft."""
    glow_cfg = config_from_voice_json(VOICE_CONFIG)
    ref = jengine.SynthesisEngine(glow_np, glow_cfg, JAudioSettings(**AUDIO),
                                  vocoder_kind="griffin_lim", griffin_lim_momentum=momentum)
    port = tengine.SynthesisEngine(params_from_jax(glow_np, "glow_tts"),
                                   t_config_from_voice_json(VOICE_CONFIG), AudioSettings(**AUDIO),
                                   vocoder_kind="griffin_lim", griffin_lim_momentum=momentum,
                                   device="cpu")
    assert port.griffin_lim_iters == ref.griffin_lim_iters == 60
    lens = np.array([40, 64, 23, 1], dtype=np.int64)  # the last row is padding
    rng = np.random.default_rng(5)
    # normalised mels of a trained voice's level: amplitudes 1e-5 .. 7
    mel = rng.uniform(0.5, 0.62, size=(4, 64, 80)).astype(np.float32)
    mask = (np.arange(64)[None, :] < lens[:, None]).astype(np.float32)
    ref_parts = ref.vocode_launch(jnp.asarray(mel), jnp.asarray(mask), 3, 0.0,
                                  jax.random.PRNGKey(0), y_lengths=lens)
    parts = port.vocode_launch(torch.from_numpy(mel), torch.from_numpy(mask), 3, 0.0,
                               y_lengths=lens)
    assert [idx for _, idx in parts] == [idx for _, idx in ref_parts] == [[0, 1, 2, 3]]
    rows = port.crop_rows(port.vocode_collect(parts, 4), lens, 3, 0.0)
    ref_rows = ref.crop_rows(ref.vocode_collect(ref_parts, 4), lens, 3, 0.0)
    for row, ref_row, y in zip(rows, ref_rows, lens):
        assert row.shape == ((y - 1) * 256 + 1024,)
        assert np.abs(row.astype(np.int32)).max() > 1000
        _gl_close(row, ref_row)


def test_engine_griffin_lim_momentum_follows_the_env(glow_np, monkeypatch):
    cfg = t_config_from_voice_json(VOICE_CONFIG)
    glow = params_from_jax(glow_np, "glow_tts")
    make = lambda: tengine.SynthesisEngine(glow, cfg, AudioSettings(**AUDIO),  # noqa: E731
                                           vocoder_kind="griffin_lim", device="cpu")
    assert make().griffin_lim_momentum == 0.99
    monkeypatch.setenv("LARYNX_TPU_GL_MOMENTUM", "0")
    assert make().griffin_lim_momentum == 0.0
    with pytest.raises(RuntimeError, match="mel-only"):
        tengine.SynthesisEngine(glow, cfg, AudioSettings(**AUDIO), vocoder_kind="none",
                                device="cpu").vocode_launch(torch.zeros((1, 64, 80)),
                                                            torch.ones((1, 64)), 1, 0.0)


# -----------------------------------------------------------------------------
# The library through the fallback and Griffin-Lim


def _library(package, call, voices, vocoder, voice=VOICE, **kwargs):
    extra = {"device": "cpu"} if package is larynx_tpu_torch else {}
    return getattr(package, call)(TEXT, voice_or_lang=voice, vocoder_or_quality=vocoder,
                                  custom_voices_dir=voices, tts_settings={"noise_scale": 0.0},
                                  **kwargs, **extra)


def test_stream_waveglow_goes_through_the_fallback(voices):
    """One chunk per sentence, each the JAX stream's fallback chunk."""
    ref = list(_library(larynx_tpu, "stream_text_to_speech", voices, WAVEGLOW))
    out = list(_library(larynx_tpu_torch, "stream_text_to_speech", voices, WAVEGLOW))
    assert len(out) == len(ref) == 2
    for o, r in zip(out, ref):
        assert np.abs(o.astype(np.int32)).max() > 1000
        assert _lsb(o, r) <= LSB


def test_stream_griffin_lim_goes_through_the_fallback(voices, injected_phase):
    ref = list(_library(larynx_tpu, "stream_text_to_speech", voices, "griffin_lim", GL_VOICE))
    out = list(_library(larynx_tpu_torch, "stream_text_to_speech", voices, "griffin_lim",
                        GL_VOICE))
    assert len(out) == len(ref) == 2
    for o, r in zip(out, ref):
        assert np.abs(o.astype(np.int32)).max() > 1000
        _gl_close(o, r)


@pytest.mark.parametrize("momentum", ["0", "0.99"], ids=["plain", "fast"])
def test_text_to_speech_griffin_lim_matches_jax(voices, injected_phase, monkeypatch, momentum):
    """The engine's batched Griffin-Lim behind text_to_speech, noise 0."""
    monkeypatch.setenv("LARYNX_TPU_GL_MOMENTUM", momentum)
    ref = list(_library(larynx_tpu, "text_to_speech", voices, "griffin_lim", GL_VOICE))
    out = list(_library(larynx_tpu_torch, "text_to_speech", voices, "griffin_lim", GL_VOICE))
    assert len(out) == len(ref) == 2
    for o, r in zip(out, ref):
        assert o.text == r.text and np.abs(o.audio.astype(np.int32)).max() > 1000
        _gl_close(o.audio, r.audio)


FALLBACK_SETTINGS = {"vocoder_settings": {"denoiser_strength": 0.01}}


@pytest.fixture(scope="module")
def fallback_ref(voices):
    """The JAX package's ``text_to_speech`` through its fallback (no
    engine), denoised by the call's vocoder settings: the reference of both
    routes, run once."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(larynx_tpu, "_get_engine", lambda *args, **kwargs: None)
        return list(_library(larynx_tpu, "text_to_speech", voices, VOCODER, **FALLBACK_SETTINGS))


@pytest.mark.parametrize("route", ["batch", "scheduler"])
def test_text_to_speech_fallback_matches_jax(voices, fallback_ref, monkeypatch, route):
    """Where _get_engine has no engine (a model class of the caller's own)
    both packages take the fallback, in the batch loop and in the
    scheduler branch: HiFi-GAN audio within 2 LSB, denoised by the call's
    vocoder settings."""
    monkeypatch.setattr(larynx_tpu, "_get_engine", lambda *args, **kwargs: None)
    monkeypatch.setattr(larynx_tpu_torch, "_get_engine", lambda *args, **kwargs: None)
    ref = fallback_ref
    kwargs = dict(FALLBACK_SETTINGS)
    scheduler = None
    if route == "scheduler":
        scheduler = kwargs["scheduler"] = BatchScheduler()
    try:
        out = list(_library(larynx_tpu_torch, "text_to_speech", voices, VOCODER, **kwargs))
    finally:
        if scheduler is not None:
            scheduler.shutdown()
    assert len(out) == len(ref) == 2
    if scheduler is not None:
        assert scheduler.jobs_run == 0  # nothing was submitted
    for o, r in zip(out, ref):
        assert _lsb(o.audio, r.audio) <= LSB


def test_get_vocoder_model_sets_the_model_defaults(voices):
    _clear_caches()
    voc = larynx_tpu_torch.get_vocoder_model(VOCODER, custom_voices_dir=voices, no_download=True,
                                             half=True, denoiser_strength=0.02)
    assert voc.half is True and voc.denoiser_strength == 0.02
    # cached by name, as in larynx_tpu: the first load's defaults stay
    assert larynx_tpu_torch.get_vocoder_model(VOCODER, custom_voices_dir=voices) is voc
    tts = larynx_tpu_torch.get_tts_model(VOICE, custom_voices_dir=voices, no_download=True,
                                         half=True)
    assert tts.half is True
    _clear_caches()


def test_griffin_lim_engine_from_get_engine(voices):
    tts, voc = _models(voices, larynx_tpu_torch, vocoder="griffin_lim")
    engine = larynx_tpu_torch._get_engine(tts, voc, torch.device("cpu"))
    assert engine.vocoder_kind == "griffin_lim" and engine.vocoder_params is None
    assert engine.upsample == 256 and tuple(engine._gl_basis.shape) == (80, 513)
    assert larynx_tpu_torch._get_engine(tts, voc, torch.device("cpu")) is engine
    assert larynx_tpu_torch._get_engine(tts, object(), torch.device("cpu")) is None

