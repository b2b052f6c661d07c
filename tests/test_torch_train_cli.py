"""The port's training CLIs end to end on the CPU: a tiny corpus ->
``python -m larynx_tpu_torch.train`` and ``train_vocoder`` (``--device
cpu``, 2 steps each) -> a voice dir and a vocoder dir that both packages
load and synthesise with.

Tolerance on the int16 audio of both packages from the trained dirs: 2 LSB
per sample, as ``tests/test_torch_pipeline.py`` (float32 rounding moves a
sample across an integer step at most once, the peak as much).
"""

import json

import numpy as np
import pytest

import larynx_tpu
import larynx_tpu_torch
from larynx_tpu_torch import train, train_vocoder
from larynx_tpu_torch.convert.native import load_params
from larynx_tpu_torch.io import wavfile

from test_torch_pipeline import PHONEME_TABLE, VOCODER_CONFIG, VOICE_CONFIG

VOICE = "en-us_trained_port-glow_tts"
VOCODER = "hifi_gan/trained_port"
TEXT = "A voice is born. Testing one two three."


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train_cli")
    wav_dir = root / "wavs"
    wav_dir.mkdir()
    rng = np.random.default_rng(0)
    texts = ["Hello world.", "A voice is born.", "Testing one two three.", "The quick brown fox."]
    rows = []
    for i, text in enumerate(texts):
        n = int(22050 * (0.6 + 0.15 * i))
        t = np.arange(n) / 22050.0
        audio = 0.3 * np.sin(2 * np.pi * (120 + 20 * i) * t) + 0.05 * rng.standard_normal(n)
        wavfile.write(wav_dir / f"utt{i}.wav", 22050, (audio * 32767).astype(np.int16))
        rows.append(f"utt{i}|{text}")
    (root / "metadata.csv").write_text("\n".join(rows), encoding="utf-8")
    (root / "config.json").write_text(json.dumps(VOICE_CONFIG), encoding="utf-8")
    (root / "vocoder.json").write_text(json.dumps(VOCODER_CONFIG), encoding="utf-8")
    (root / "phonemes.txt").write_text(
        "".join(f"{i} {p}\n" for i, p in enumerate(PHONEME_TABLE)), encoding="utf-8")
    return root


@pytest.fixture(scope="module")
def trained(corpus):
    voices = corpus / "voices"
    lang, name = VOICE.split("_", 1)
    _, voice_history = train.main([
        "--metadata", str(corpus / "metadata.csv"), "--wav-dir", str(corpus / "wavs"),
        "--output-dir", str(voices / lang / name), "--config", str(corpus / "config.json"),
        "--phonemes", str(corpus / "phonemes.txt"), "--batch-size", "2", "--epochs", "1",
        "--max-id-len", "64", "--max-mel-len", "128", "--ddi", "--warmup-steps", "1",
        "--device", "cpu",
    ])
    _, vocoder_history = train_vocoder.main([
        "--wav-dir", str(corpus / "wavs"), "--out-dir", str(voices / VOCODER),
        "--config", str(corpus / "vocoder.json"), "--segment-frames", "16", "--batch-size", "2",
        "--steps", "2", "--device", "cpu",
    ])
    return voices, voice_history, vocoder_history


def test_train_cli_writes_a_voice_dir(corpus, trained):
    voices, history, _ = trained
    voice_dir = voices / "en-us" / VOICE.split("_", 1)[1]
    assert len(history) == 2
    assert all(np.isfinite(float(m[k])) for m in history for k in ("loss", "mle_loss",
                                                                     "duration_loss"))
    assert json.loads((voice_dir / "config.json").read_text()) == VOICE_CONFIG
    assert (voice_dir / "phonemes.txt").read_text() == (corpus / "phonemes.txt").read_text()
    invconv = load_params(voice_dir / "generator.npz")["decoder"]["invconv"]
    np.testing.assert_allclose(invconv["weight"].astype(np.float64) @ invconv["weight_inv"],
                               np.broadcast_to(np.eye(4), invconv["weight"].shape), atol=1e-6)


def test_train_cli_resume_loads_parameters_only(corpus, trained, tmp_path, caplog):
    """``--resume`` starts from the saved parameters with a fresh optimizer
    and schedule, and says so."""
    start = corpus / "voices" / "en-us" / VOICE.split("_", 1)[1] / "generator.npz"
    with caplog.at_level("INFO", logger="larynx_tpu_torch.train"):
        state, history = train.main([
            "--metadata", str(corpus / "metadata.csv"), "--wav-dir", str(corpus / "wavs"),
            "--output-dir", str(tmp_path / "resumed"), "--config", str(corpus / "config.json"),
            "--phonemes", str(corpus / "phonemes.txt"), "--batch-size", "2", "--epochs", "1",
            "--max-id-len", "64", "--max-mel-len", "128", "--resume", str(start),
            "--device", "cpu"])
    assert "learning-rate schedule start again at step 0" in caplog.text
    assert state.opt_state.count == len(history) == 2
    before, after = load_params(start), load_params(tmp_path / "resumed" / "generator.npz")
    moved = np.abs(after["encoder"]["emb"] - before["encoder"]["emb"]).max()
    assert 0 < moved < 1e-3  # two small steps from the saved parameters, not a new init


def test_train_vocoder_cli_writes_a_vocoder_dir(trained):
    voices, _, history = trained
    assert len(history) == 2
    assert all(np.isfinite(float(m[k])) for m in history for k in ("d_loss", "g_loss", "mel_l1"))
    written = json.loads((voices / VOCODER / "config.json").read_text())
    assert written["model"] == VOCODER_CONFIG["model"]
    assert written["audio"] == {"num_mels": 80, "sampling_rate": 22050}


def test_trained_dirs_synthesize_in_both_packages(trained):
    voices = trained[0]

    def run(module, **extra):
        return list(module.text_to_speech(
            TEXT, voice_or_lang=VOICE, vocoder_or_quality=VOCODER, custom_voices_dir=voices,
            no_download=True, tts_settings={"noise_scale": 0.0}, **extra))

    larynx_tpu._TTS_MODEL_CACHE.clear()
    larynx_tpu._VOCODER_MODEL_CACHE.clear()
    try:
        ref = run(larynx_tpu)
        out = run(larynx_tpu_torch, device="cpu")
    finally:
        larynx_tpu._TTS_MODEL_CACHE.clear()
        larynx_tpu._VOCODER_MODEL_CACHE.clear()
    assert len(out) == len(ref) == 2
    for r, o in zip(ref, out):
        assert o.audio.shape == r.audio.shape and o.audio.dtype == np.int16
        assert np.abs(r.audio.astype(np.int32)).max() > 1000
        assert np.abs(o.audio.astype(np.int32) - r.audio.astype(np.int32)).max() <= 2
