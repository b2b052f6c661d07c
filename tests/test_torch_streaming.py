"""The port's streaming synthesis against the JAX package, on CPU.

``SynthesisEngine.synthesize_stream`` and ``stream_text_to_speech`` of both
packages run on the same numpy params (a small GlowTTS voice with perturbed
coupling end convs and a small ResBlock1 HiFi-GAN) at ``noise_scale`` 0, so
both sides see the same latent.

Tolerances on the int16 chunks:
  * port against JAX, chunk by chunk: 2 LSB, same chunk lengths.  Both
    sides scale float32 audio by 32767 at fixed gain and truncate toward
    zero; float32 sums in other orders move a sample across an integer
    boundary at most once, the denoiser's FFTs (torch.fft against
    pocketfft) once more.
  * chunked against one window, the port alone: 1 LSB, under 0.1% of the
    samples differing (``tests/test_streaming.py``'s bound): the halo makes
    each chunk's samples those of the one-window run up to the summation
    order of a shorter conv.
  * stream against the batch path: same length, correlation > 0.9999 (the
    batch path peak-normalises each row, the stream does not).
"""

import jax
import numpy as np
import pytest
import torch

import larynx_tpu
from larynx_tpu.audio import AudioSettings as JAudioSettings
from larynx_tpu.models.glow_tts import config_from_voice_json
from larynx_tpu.models.glow_tts import init_params as j_glow_init
from larynx_tpu.models.hifi_gan import HiFiGanConfig as JHiFiGanConfig
from larynx_tpu.models.hifi_gan import hifi_gan_config_from_json
from larynx_tpu.models.hifi_gan import init_params as j_hifi_init
from larynx_tpu.runtime.engine import SynthesisEngine as JEngine
from larynx_tpu.runtime.engine import stream_halo_frames as j_stream_halo_frames

import larynx_tpu_torch
from larynx_tpu_torch.audio import AudioSettings
from larynx_tpu_torch.models import glow_tts as t_glow
from larynx_tpu_torch.models.hifi_gan import HiFiGanConfig
from larynx_tpu_torch.models.hifi_gan import hifi_gan_config_from_json as t_hifi_config
from larynx_tpu_torch.models.waveglow import WaveGlowConfig
from larynx_tpu_torch.runtime import engine as tengine
from larynx_tpu_torch.weights import init_params, params_from_jax

from test_torch_pipeline import (  # noqa: F401
    AUDIO, VOCODER, VOCODER_CONFIG, VOICE, VOICE_CONFIG, voices_dir,
)

GEOMETRIES = {
    "universal_large": {},
    "vctk_medium": dict(upsample_initial_channel=128),
    "vctk_small": dict(
        resblock="2", upsample_initial_channel=256, upsample_rates=(8, 8, 4),
        upsample_kernel_sizes=(16, 16, 8), resblock_kernel_sizes=(3, 5, 7),
        resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)),
    ),
}
IDS = np.arange(1, 40, dtype=np.int64) % 45 + 1
CHUNK = 16


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_stream_halo_frames_matches_jax(name):
    halo = tengine.stream_halo_frames(HiFiGanConfig(**GEOMETRIES[name]))
    assert halo == j_stream_halo_frames(JHiFiGanConfig(**GEOMETRIES[name]))
    if name == "universal_large":
        assert halo == 14


@pytest.fixture(scope="module")
def engines():
    """The JAX engine and the port's (CPU) on the same small params."""
    glow_np = jax.tree.map(np.asarray, j_glow_init(jax.random.PRNGKey(0),
                                                   config_from_voice_json(VOICE_CONFIG)))
    cp = glow_np["decoder"]["coupling"]  # give the zero-init coupling output signal
    rng = np.random.default_rng(0)
    cp["end_w"] = (rng.standard_normal(cp["end_w"].shape) * 0.05).astype(np.float32)
    voc_cfg = hifi_gan_config_from_json(VOCODER_CONFIG)
    voc_np = jax.tree.map(np.asarray, j_hifi_init(jax.random.PRNGKey(1), voc_cfg))
    ref = JEngine(glow_np, config_from_voice_json(VOICE_CONFIG), JAudioSettings(**AUDIO),
                  vocoder_kind="hifi_gan", vocoder_params=voc_np, vocoder_cfg=voc_cfg, seed=7)
    port = tengine.SynthesisEngine(
        params_from_jax(glow_np, "glow_tts"), t_glow.config_from_voice_json(VOICE_CONFIG),
        AudioSettings(**AUDIO), vocoder_params=params_from_jax(voc_np, "hifi_gan"),
        vocoder_cfg=t_hifi_config(VOCODER_CONFIG), seed=7, device="cpu",
    )
    return ref, port


def _lsb(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


@pytest.mark.parametrize("denoiser_strength", [0.0, 0.005], ids=["plain", "denoised"])
def test_synthesize_stream_matches_jax(engines, denoiser_strength):
    ref, port = engines
    kwargs = dict(noise_scale=0.0, chunk_frames=CHUNK, denoiser_strength=denoiser_strength)
    want = list(ref.synthesize_stream(IDS, **kwargs))
    got = list(port.synthesize_stream(IDS, **kwargs))
    assert len(got) == len(want) > 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.int16 and g.shape == w.shape, i
        assert _lsb(g, w) <= 2, f"chunk {i}: {_lsb(g, w)} LSB apart"
    assert np.abs(np.concatenate(want).astype(np.int32)).max() > 300  # not silence


@pytest.mark.parametrize("denoiser_strength", [0.0, 0.005], ids=["plain", "denoised"])
def test_chunked_equals_one_window(engines, denoiser_strength):
    _ref, port = engines
    kwargs = dict(seed=5, denoiser_strength=denoiser_strength)
    chunks = list(port.synthesize_stream(IDS, chunk_frames=CHUNK, **kwargs))
    whole = list(port.synthesize_stream(IDS, chunk_frames=10**6, **kwargs))
    assert len(chunks) > 2 and len(whole) == 1
    streamed, reference = np.concatenate(chunks), whole[0]
    assert streamed.shape == reference.shape and streamed.size > 1000
    diff = np.abs(streamed.astype(np.int32) - reference.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert np.mean(diff != 0) < 1e-3, np.mean(diff != 0)


def test_stream_duration_matches_batch(engines):
    _ref, port = engines
    streamed = np.concatenate(list(port.synthesize_stream(IDS, seed=3, chunk_frames=CHUNK)))
    batch = port.synthesize_batch([IDS], seed=3)[0]
    assert streamed.dtype == np.int16 and len(streamed) == len(batch)
    a, b = streamed.astype(np.float64), batch.astype(np.float64)
    corr = np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9)
    assert corr > 0.9999, corr


def test_stream_text_to_speech_ssml_pause_matches_jax(voices_dir):  # noqa: F811
    """An SSML break becomes a silence chunk of its length between the two
    sentences' chunks, on both sides."""
    text = ('<speak>The birch canoe slid on the smooth planks.<break time="250ms"/>'
            "Glue the sheet.</speak>")
    kwargs = dict(voice_or_lang=VOICE, vocoder_or_quality=VOCODER, ssml=True,
                  custom_voices_dir=voices_dir, tts_settings={"noise_scale": 0.0},
                  chunk_frames=CHUNK)
    want = list(larynx_tpu.stream_text_to_speech(text, **kwargs))
    got = list(larynx_tpu_torch.stream_text_to_speech(text, device="cpu", no_download=True,
                                                       **kwargs))
    assert [len(c) for c in got] == [len(c) for c in want]
    pause = 250 * 22050 // 1000
    silent = [i for i, c in enumerate(got) if len(c) == pause and not c.any()]
    assert len(silent) == 1 and 0 < silent[0] < len(got) - 1
    assert _lsb(np.concatenate(got), np.concatenate(want)) <= 2


def test_stream_requires_hifi_gan():
    """A WaveGlow engine rejects streaming with a ValueError, as in the JAX package."""
    glow_cfg = t_glow.config_from_voice_json(VOICE_CONFIG)
    wg_cfg = WaveGlowConfig(
        mel_channels=80, flows=2, groups=8, early_every=2, early_size=2, wn_kernel_size=3,
        wn_channels=16, wn_layers=2, upsample_kernel=512, upsample_stride=256,
    )
    eng = tengine.SynthesisEngine(
        params_from_jax(init_params(torch.Generator().manual_seed(0), glow_cfg), "glow_tts"),
        glow_cfg, AudioSettings(**AUDIO), vocoder_kind="waveglow",
        vocoder_params=params_from_jax(init_params(torch.Generator().manual_seed(1), wg_cfg),
                                       "waveglow"),
        vocoder_cfg=wg_cfg, device="cpu",
    )
    with pytest.raises(ValueError, match="HiFi-GAN"):
        next(eng.synthesize_stream(IDS))
