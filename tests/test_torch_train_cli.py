"""The port's training CLIs end to end on the CPU: a tiny corpus ->
``python -m larynx_tpu_torch.train`` (GlowTTS and ``--family tacotron2``)
and ``train_vocoder`` (HiFi-GAN and ``--family waveglow``), ``--device
cpu``, 2-3 steps each -> voice and vocoder dirs that both packages load
(the GlowTTS voice and the HiFi-GAN vocoder also synthesise with both), at
the JAX CLI tests' geometries (``tests/test_train_cli.py``).

Tolerances: the int16 audio of both packages from the trained GlowTTS and
HiFi-GAN dirs within 2 LSB per sample, as ``tests/test_torch_pipeline.py``
(float32 rounding moves a sample across an integer step at most once, the
peak as much); the saved WaveGlow inverses w @ w_inv = I within 1e-5
(float32 storage of inv(w) computed in float64).
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


# tests/test_train_cli.py's geometries
WAVEGLOW = {"mel_channels": 80, "sampling_rate": 22050, "flows": 2, "groups": 8,
            "early_every": 2, "early_size": 2, "wn_kernel_size": 3, "wn_channels": 16,
            "wn_layers": 1, "upsample_kernel": 512, "upsample_stride": 256}
TACOTRON2 = {"symbols_embedding_dim": 32, "encoder_embedding_dim": 32,
             "encoder_n_convolutions": 1, "prenet_dim": 16, "attention_rnn_dim": 48,
             "decoder_rnn_dim": 48, "attention_dim": 24, "attention_location_n_filters": 8,
             "attention_location_kernel_size": 15, "postnet_embedding_dim": 32,
             "postnet_n_convolutions": 2, "max_decoder_steps": 60}
T2_VOICE = "en-us_trained_port-tacotron2"
WG_VOCODER = "waveglow/trained_port"


def _t2_argv(corpus, out_dir, *extra):
    return ["--family", "tacotron2", "--metadata", str(corpus / "metadata.csv"),
            "--wav-dir", str(corpus / "wavs"), "--output-dir", str(out_dir),
            "--config", str(corpus / "t2.json"), "--phonemes", str(corpus / "phonemes.txt"),
            "--epochs", "1", "--max-id-len", "64", "--max-mel-len", "96", "--device", "cpu",
            *extra]


@pytest.fixture(scope="module")
def trained_more(corpus):
    """The two later families: a Tacotron2 voice (2 steps) and a WaveGlow
    vocoder (3 steps, sigma 0.7), with their histories."""
    voices = corpus / "voices"
    (corpus / "t2.json").write_text(json.dumps({"audio": {}, "model": TACOTRON2}))
    (corpus / "wg.json").write_text(json.dumps(WAVEGLOW))
    lang, name = T2_VOICE.split("_", 1)
    _, t2_history = train.main(_t2_argv(corpus, voices / lang / name, "--batch-size", "2"))
    _, wg_history = train_vocoder.main([
        "--family", "waveglow", "--wav-dir", str(corpus / "wavs"),
        "--out-dir", str(voices / WG_VOCODER), "--config", str(corpus / "wg.json"),
        "--segment-frames", "8", "--batch-size", "2", "--steps", "3", "--sigma", "0.7",
        "--device", "cpu"])
    return voices, t2_history, wg_history


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


def test_train_vocoder_cli_waveglow_writes_a_vocoder_dir(trained_more):
    """Both packages load the dir, with the trained sigma; the saved 1x1
    inverses invert the trained weights."""
    voices, _, history = trained_more
    assert len(history) == 3 and all(np.isfinite(m["nll"]) for m in history)
    written = json.loads((voices / WG_VOCODER / "config.json").read_text())
    assert written == dict(WAVEGLOW, sigma=0.7)
    tree = load_params(voices / WG_VOCODER / "generator.npz")
    for flow in tree["flows"]:
        w = flow["convinv"]["w"].astype(np.float64)
        np.testing.assert_allclose(w @ flow["convinv"]["w_inv"], np.eye(w.shape[0]), atol=1e-5)
    mels = np.log(np.maximum(1e-5, np.random.default_rng(0).uniform(0, 2, (80, 12))))
    for module, kwargs in ((larynx_tpu, {}), (larynx_tpu_torch, {"device": "cpu"})):
        module._VOCODER_MODEL_CACHE.clear()
        try:
            vocoder = module.get_vocoder_model(WG_VOCODER, custom_voices_dir=voices,
                                               no_download=True)
            assert vocoder.sigma == pytest.approx(0.7)
            audio = vocoder.mels_to_audio(mels.astype(np.float32), **kwargs)
        finally:
            module._VOCODER_MODEL_CACHE.clear()
        assert audio.size == 12 * 256 and np.isfinite(audio.astype(np.float32)).all()


def test_train_cli_tacotron2_writes_a_voice_dir(corpus, trained_more):
    """A ``-tacotron2`` voice that both packages load and decode, with
    ``num_symbols`` sized from the phoneme table and persisted."""
    voices, history, _ = trained_more
    assert len(history) == 2
    voice_dir = voices / "en-us" / T2_VOICE.split("_", 1)[1]
    written = json.loads((voice_dir / "config.json").read_text())
    assert written["model"] == dict(TACOTRON2, num_symbols=len(PHONEME_TABLE))
    ids = np.asarray([3, 5, 9, 3, 2], dtype=np.int64)
    for module, kwargs in ((larynx_tpu, {}), (larynx_tpu_torch, {"device": "cpu"})):
        module._TTS_MODEL_CACHE.clear()
        try:
            model = module.get_tts_model(T2_VOICE, custom_voices_dir=voices, no_download=True)
            mels = model.phonemes_to_mels(ids, **kwargs)
        finally:
            module._TTS_MODEL_CACHE.clear()
        assert mels.shape[1] == 80 and np.isfinite(mels).all()


def test_train_cli_tacotron2_resume_says_the_warmup_restarts(corpus, trained_more, tmp_path,
                                                             caplog):
    start = trained_more[0] / "en-us" / T2_VOICE.split("_", 1)[1] / "generator.npz"
    with caplog.at_level("INFO", logger="larynx_tpu_torch.train"):
        state, history = train.main(_t2_argv(corpus, tmp_path / "resumed-tacotron2",
                                             "--batch-size", "4", "--resume", str(start)))
    assert "the linear warmup and Adam's moments start again at step 0" in caplog.text
    assert state.opt_state.count == len(history) == 1
    # the first update of the restarted warmup has a rate of 0
    before, after = load_params(start), load_params(tmp_path / "resumed-tacotron2" /
                                                    "generator.npz")
    np.testing.assert_array_equal(after["embedding"], before["embedding"])


def test_train_cli_empty_phoneme_table_fails_before_the_output_dir(corpus, tmp_path):
    (tmp_path / "phonemes.txt").write_text("")
    out_dir = tmp_path / "voice-tacotron2"
    argv = [a if a != str(corpus / "phonemes.txt") else str(tmp_path / "phonemes.txt")
            for a in _t2_argv(corpus, out_dir)]
    with pytest.raises(SystemExit, match="phonemes.txt"):
        train.main(argv)
    assert not out_dir.exists()


@pytest.mark.parametrize("family", ["glow_tts", "hifi_gan", "tacotron2", "waveglow"])
def test_trainers_return_host_float_histories(trained, trained_more, family):
    """``main``'s history holds Python floats, not device tensors: a trainer
    keeps at most LOG_EVERY steps of metrics on the device."""
    history = {"glow_tts": trained[1], "hifi_gan": trained[2], "tacotron2": trained_more[1],
               "waveglow": trained_more[2]}[family]
    assert history and all(type(v) is float for m in history for v in m.values())
