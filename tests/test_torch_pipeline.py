"""The port's engine and ``text_to_speech`` against the JAX package, on CPU.

One synthetic voices dir (written here: a small GlowTTS voice, a small
HiFi-GAN vocoder and the 46-symbol en-us ``phonemes.txt``) feeds both
``larynx_tpu.text_to_speech`` and ``larynx_tpu_torch.text_to_speech`` with
``noise_scale`` 0, so the two runs see the same text, params and latent.

Tolerance on the int16 audio: 2 LSB per sample, same length per sentence.
Both sides peak-normalise float32 audio to +-32767 and truncate toward
zero; float32 rounding differences of ~1e-7 relative in the vocoder output
move a sample across an integer boundary at most once, and the peak itself
can shift by as much, so two steps bound it.
"""

import json

import jax
import numpy as np
import pytest
import torch

import larynx_tpu
import larynx_tpu.dsp.mel as jmel
from larynx_tpu.audio import AudioSettings as JAudioSettings
from larynx_tpu.convert.native import save_params
from larynx_tpu.models.glow_tts import config_from_voice_json
from larynx_tpu.models.glow_tts import init_params as j_glow_init
from larynx_tpu.models.hifi_gan import hifi_gan_config_from_json
from larynx_tpu.models.hifi_gan import init_params as j_hifi_init
from larynx_tpu.runtime.engine import SynthesisEngine as JEngine

import larynx_tpu_torch
import larynx_tpu_torch.dsp.mel as tmel
from larynx_tpu_torch.audio import AudioSettings
from larynx_tpu_torch.runtime import engine as tengine
from larynx_tpu_torch.weights import params_from_jax

VOICE = "en-us_torch_port_parity-glow_tts"
VOCODER = "hifi_gan/torch_port_parity"

# 46-symbol en-us voice inventory (the harvard voice's phonemes.txt)
PHONEME_TABLE = (
    "_ | ‖ # ˈ ˌ aɪ aʊ b d d͡ʒ eɪ f h i j k l m n oʊ p s t t͡ʃ u v w z æ ð ŋ ɑ ɔ ɔɪ ə ɚ ɛ ɡ ɪ ɹ ʃ ʊ ʌ ʒ θ"
).split()

AUDIO = {
    "filter_length": 1024, "hop_length": 256, "win_length": 1024, "mel_channels": 80,
    "sample_rate": 22050, "sample_bytes": 2, "channels": 1, "mel_fmin": 0.0,
    "mel_fmax": 8000.0, "ref_level_db": 20.0, "spec_gain": 1.0, "signal_norm": True,
    "min_level_db": -100.0, "max_norm": 1.0, "clip_norm": True, "symmetric_norm": True,
    "do_dynamic_range_compression": True, "convert_db_to_amp": True,
}
VOICE_CONFIG = {
    "audio": AUDIO,
    "model": {
        "num_symbols": 46, "hidden_channels": 64, "filter_channels": 128,
        "filter_channels_dp": 64, "kernel_size": 3, "n_blocks_dec": 2, "n_layers_enc": 2,
        "n_heads": 2, "kernel_size_dec": 5, "dilation_rate": 1, "n_block_layers": 2,
        "n_sqz": 2, "prenet": True, "mean_only": True, "window_size": 4, "n_speakers": 1,
        "n_split": 4,
    },
}
VOCODER_CONFIG = {
    "audio": {"num_mels": 80, "sampling_rate": 22050},
    "model": {
        "resblock": "1", "upsample_rates": [8, 8, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4],
        "upsample_initial_channel": 32, "resblock_kernel_sizes": [3, 7, 11],
        "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    },
}

TEXT = (
    "The beige hue on the waters of the loch impressed all. "
    "Hello world, this is a test of the port."
)


@pytest.fixture(scope="module")
def voices_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_port_voices")
    lang, rest = VOICE.split("_", 1)
    voice_dir = root / lang / rest
    voice_dir.mkdir(parents=True)
    (voice_dir / "config.json").write_text(json.dumps(VOICE_CONFIG), encoding="utf-8")
    (voice_dir / "phonemes.txt").write_text(
        "".join(f"{i} {p}\n" for i, p in enumerate(PHONEME_TABLE)), encoding="utf-8"
    )
    params = jax.tree.map(np.asarray, j_glow_init(jax.random.PRNGKey(0), config_from_voice_json(VOICE_CONFIG)))
    rng = np.random.default_rng(0)
    cp = params["decoder"]["coupling"]  # give the zero-init coupling output signal
    cp["end_w"] = (rng.standard_normal(cp["end_w"].shape) * 0.05).astype(np.float32)
    save_params(voice_dir / "generator.npz", params)

    voc_dir = root / VOCODER
    voc_dir.mkdir(parents=True)
    (voc_dir / "config.json").write_text(json.dumps(VOCODER_CONFIG), encoding="utf-8")
    voc_cfg = hifi_gan_config_from_json(VOCODER_CONFIG)
    save_params(voc_dir / "generator.npz", j_hifi_init(jax.random.PRNGKey(1), voc_cfg))
    return root


def _synthesize(module, voices_dir, **kwargs):
    extra = {"device": "cpu"} if module is larynx_tpu_torch else {}
    return list(
        module.text_to_speech(
            TEXT, voice_or_lang=VOICE, vocoder_or_quality=VOCODER,
            custom_voices_dir=voices_dir, no_download=True,
            tts_settings={"noise_scale": 0.0}, **kwargs, **extra,
        )
    )


@pytest.mark.parametrize("denoiser_strength", [0.0, 0.01], ids=["plain", "denoised"])
def test_text_to_speech_matches_jax(voices_dir, denoiser_strength):
    ref = _synthesize(larynx_tpu, voices_dir, denoiser_strength=denoiser_strength)
    out = _synthesize(larynx_tpu_torch, voices_dir, denoiser_strength=denoiser_strength)
    assert len(out) == len(ref) == 2
    for r, o in zip(ref, out):
        assert o.text == r.text
        assert o.sample_rate == r.sample_rate
        assert o.audio.dtype == np.int16
        assert o.audio.shape == r.audio.shape
        assert np.abs(r.audio.astype(np.int32)).max() > 1000
        diff = np.abs(o.audio.astype(np.int32) - r.audio.astype(np.int32)).max()
        assert diff <= 2, f"{diff} LSB apart"


def test_text_to_speech_seeded_noise_is_reproducible(voices_dir):
    run = lambda seed: [  # noqa: E731
        r.audio
        for r in larynx_tpu_torch.text_to_speech(
            TEXT, voice_or_lang=VOICE, vocoder_or_quality=VOCODER, custom_voices_dir=voices_dir,
            no_download=True, seed=seed, device="cpu",
        )
    ]
    a, b, c = run(3), run(3), run(4)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


def test_mel_postprocess_matches_jax():
    rng = np.random.default_rng(0)
    mels = rng.uniform(-1.5, 1.5, size=(2, 80, 30)).astype(np.float32)
    for flags in ({}, {"symmetric_norm": False}, {"signal_norm": False, "convert_db_to_amp": False}):
        kwargs = {**AUDIO, **flags}
        ref = np.asarray(jmel.mel_postprocess(mels, JAudioSettings(**kwargs)))
        out = tmel.mel_postprocess(torch.from_numpy(mels), AudioSettings(**kwargs)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-6)


def test_to_int16_matches_jax_formula():
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal((3, 500)) * 0.3).astype(np.float32)
    audio[2] *= 1e-3  # below the 0.01 peak floor
    n_valid = np.array([500, 200, 500])
    out = tengine.to_int16(torch.from_numpy(audio), torch.from_numpy(n_valid)).numpy()
    for row, n, o in zip(audio, n_valid, out):
        peak = max(np.abs(row[:n]).max(), 0.01)
        expect = np.clip(row * np.float32(32767.0 / peak), -32767, 32767).astype(np.int16)
        np.testing.assert_array_equal(o, expect)


@pytest.fixture(scope="module")
def engines():
    """The JAX engine and the port's (CPU) on the same small params."""
    glow_cfg = config_from_voice_json(VOICE_CONFIG)
    voc_cfg = hifi_gan_config_from_json(VOCODER_CONFIG)
    glow_np = jax.tree.map(np.asarray, j_glow_init(jax.random.PRNGKey(0), glow_cfg))
    voc_np = jax.tree.map(np.asarray, j_hifi_init(jax.random.PRNGKey(1), voc_cfg))
    ref = JEngine(glow_np, glow_cfg, JAudioSettings(**AUDIO), vocoder_kind="hifi_gan",
                  vocoder_params=voc_np, vocoder_cfg=voc_cfg)
    port = tengine.SynthesisEngine(
        params_from_jax(glow_np, "glow_tts"),
        larynx_tpu_torch.models.glow_tts.config_from_voice_json(VOICE_CONFIG),
        AudioSettings(**AUDIO),
        vocoder_params=params_from_jax(voc_np, "hifi_gan"),
        vocoder_cfg=larynx_tpu_torch.models.hifi_gan.hifi_gan_config_from_json(VOCODER_CONFIG),
        device="cpu",
    )
    return ref, port


@pytest.mark.parametrize(
    "lens,m,denoise",
    [
        ([60, 58, 30, 12, 11], 64, False),
        ([2000, 1900, 1800, 1700, 1500, 900, 400, 100], 2048, False),
        ([4000] * 8, 4096, True),
        ([700], 768, True),
        ([3000, 2900, 2800, 2700, 2600, 2500, 2400, 2300, 2200, 2100, 1000, 900], 3072, False),
    ],
)
def test_ragged_group_plan_matches_jax(engines, lens, m, denoise):
    """Every row is vocoded at the JAX engine's width."""
    ref, port = engines
    sorted_lens = np.asarray(lens, dtype=np.int64)
    margin = 4 if denoise else 0
    assert port._ragged_group_plan(sorted_lens, len(lens), m, tengine.MAX_VOCODE_AREA, margin) == \
        ref._ragged_group_plan(sorted_lens, len(lens), m, 16384, margin)


def test_engine_crop_lengths(engines):
    """Crops are y_length * 256 samples, or the denoised STFT length
    ceil((n - 1024) / 256) * 256 + 1024."""
    _ref, port = engines
    rows = [np.arange(5000, dtype=np.int16)] * 2
    assert [len(r) for r in port.crop_rows(rows, np.array([10, 14]), 2, 0.0)] == [2560, 3584]
    assert [len(r) for r in port.crop_rows(rows, np.array([10, 14]), 2, 0.1)] == [2560, 3584]
    assert [len(r) for r in port.crop_rows(rows, np.array([9, 11]), 2, 0.1)] == [2304, 2816]


def test_engine_synthesize_batch(engines):
    """A ragged batch comes back in input order at y_length * 256 samples."""
    _ref, port = engines
    rng = np.random.default_rng(2)
    seqs = [rng.integers(1, 46, size=n).astype(np.int64) for n in (20, 7, 13)]
    enc, _ = port.encode_launch(seqs, 1.0)
    y_lengths = enc[4].numpy()[:3]
    audio = port.synthesize_batch(seqs, noise_scale=0.0)
    assert [a.shape[0] for a in audio] == [int(y) * 256 for y in y_lengths]
    assert all(a.dtype == np.int16 and np.abs(a.astype(np.int32)).max() > 1000 for a in audio)
    single = port.synthesize_batch(seqs[1:2], noise_scale=0.0)[0]
    assert single.shape == audio[1].shape
    assert np.abs(single.astype(np.int32) - audio[1].astype(np.int32)).max() <= 2
