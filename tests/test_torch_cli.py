"""The port's CLI (``python -m larynx_tpu_torch``) on CPU, beside the JAX package's.

Counterparts of ``tests/test_cli.py`` run with ``--device cpu`` on the
synthetic voice of ``tests/test_torch_pipeline.py``, its small ResBlock1
HiFi-GAN staged as ``hifi_gan/vctk_small`` so ``--quality low`` finds it.
The WAV on stdout and the ``--stream`` PCM are held against the JAX CLI's
at ``--noise-scale 0 --denoiser-strength 0``: 2 LSB per sample, same
length (both sides compute float32 audio in other orders and truncate it
to int16; see ``tests/test_torch_pipeline.py``).
"""

import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import larynx_tpu
import larynx_tpu.__main__ as jcli

import larynx_tpu_torch
import larynx_tpu_torch.__main__ as cli
from larynx_tpu_torch.io import wavfile

from test_torch_pipeline import VOCODER, VOICE, voices_dir  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
LSB = 2


def _clear_caches():
    for module in (larynx_tpu, larynx_tpu_torch):
        module._TTS_MODEL_CACHE.clear()
        module._VOCODER_MODEL_CACHE.clear()
        module._ENGINE_CACHE.clear()


@pytest.fixture(scope="module")
def cli_voices(voices_dir):  # noqa: F811
    """The synthetic voices dir with its vocoder also under the "low" preset's name."""
    (voices_dir / "hifi_gan" / "vctk_small").symlink_to(voices_dir / VOCODER)
    _clear_caches()
    yield voices_dir
    _clear_caches()


def _args(voices, *extra):
    return [*extra, "--voice", VOICE, "--quality", "low", "--voices-dir", str(voices),
            "--denoiser-strength", "0"]


def _run(module, argv, capsysbinary, monkeypatch=None, stdin_text=None):
    if stdin_text is not None:
        monkeypatch.setattr("sys.stdin", io.TextIOWrapper(io.BytesIO(stdin_text.encode())))
    module.main(argv + (["--device", "cpu"] if module is cli else []))
    return capsysbinary.readouterr().out


def _lsb(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


@pytest.mark.parametrize("mode", ["wav", "stream"])
def test_cli_matches_jax_cli(cli_voices, capsysbinary, mode):
    """WAV on stdout (RIFF, 22050 Hz) and the --stream PCM, against the JAX CLI."""
    argv = _args(cli_voices, "The birch canoe slid on the smooth planks. Glue the sheet.",
                 "--noise-scale", "0", "--seed", "3")
    if mode == "stream":
        argv += ["--stream", "--stream-chunk-frames", "16"]
    got = _run(cli, argv, capsysbinary)
    want = _run(jcli, argv, capsysbinary)
    if mode == "wav":
        assert got[:4] == b"RIFF"
        (rate, got), (j_rate, want) = wavfile.read(io.BytesIO(got)), wavfile.read(io.BytesIO(want))
        assert rate == j_rate == 22050
    else:
        assert len(got) % 2 == 0
        got, want = np.frombuffer(got, np.int16), np.frombuffer(want, np.int16)
    assert got.shape == want.shape and got.size > 8000
    assert np.abs(want.astype(np.int32)).max() > 300
    assert _lsb(got, want) <= LSB


def test_cli_pins_float32(cli_voices, capsysbinary, monkeypatch):
    """The CLI turns TF32 off for cuDNN and cuBLAS, whatever the process had."""
    import torch

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    _run(cli, _args(cli_voices, "Rice is often served in round bowls."), capsysbinary)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_cli_raw_stream_is_the_wav_body(cli_voices, capsysbinary):
    """--raw-stream writes each sentence's int16 PCM, the WAV's samples."""
    argv = _args(cli_voices, "Rice is often served in round bowls.", "--noise-scale", "0")
    raw = np.frombuffer(_run(cli, argv + ["--raw-stream"], capsysbinary), np.int16)
    _rate, wav = wavfile.read(io.BytesIO(_run(cli, argv, capsysbinary)))
    np.testing.assert_array_equal(raw, wav)


def test_cli_output_dir(cli_voices, tmp_path, capsysbinary):
    _run(cli, _args(cli_voices, "Write me to a file.", "--output-dir", str(tmp_path)), capsysbinary)
    wavs = list(tmp_path.glob("*.wav"))
    assert len(wavs) == 1 and "Write_me_to_a_file" in wavs[0].name


@pytest.mark.parametrize("delimiter", ["|", ";"])
def test_cli_csv_mode(cli_voices, tmp_path, monkeypatch, capsysbinary, delimiter):
    argv = _args(cli_voices, "--csv", "--output-dir", str(tmp_path), "--id-delimiter", delimiter)
    _run(cli, argv, capsysbinary, monkeypatch,
         stdin_text=f"utt1{delimiter}Hello there.\nutt2{delimiter}Good bye now.\n")
    assert {p.name for p in tmp_path.glob("*.wav")} == {"utt1.wav", "utt2.wav"}


def test_cli_no_download_fails_fast(cli_voices, capsysbinary, monkeypatch):
    """--no-download never tries to fetch a missing voice."""
    calls = []

    def spy(*args, **kwargs):
        calls.append(args)
        raise RuntimeError("offline")

    monkeypatch.setattr(larynx_tpu_torch, "download_voice", spy)
    with pytest.raises(RuntimeError, match="Failed to load voice"):
        cli.main(["text", "--voice", "en-us_not_installed-glow_tts", "--voices-dir",
                  str(cli_voices), "--no-download", "--device", "cpu"])
    assert not calls


def test_cli_config_audio_overrides(cli_voices, tmp_path, capsysbinary):
    """--config JSON audio settings override the voice's config.json."""
    cfg_path = tmp_path / "audio.json"
    cfg_path.write_text(json.dumps({"audio": {"sample_rate": 16000}}))
    out = _run(cli, _args(cli_voices, "Config override test.", "--config", str(cfg_path)),
               capsysbinary)
    assert wavfile.read(io.BytesIO(out))[0] == 16000


@pytest.mark.parametrize("flags,stdin_text,calls", [
    (["--stdin-format", "document"], "First line\nsecond line.\n", ["First line\nsecond line.\n"]),
    (["--stdin-format", "lines"], "First line\nsecond line.\n", ["First line", "second line."]),
    (["--process-on-blank-line"], "One\ntwo.\n\nThree.\n\nDropped\n", ["One two.", "Three."]),
], ids=["document", "lines", "blank-line-paragraphs"])
def test_cli_stdin_formats(cli_voices, capsysbinary, monkeypatch, flags, stdin_text, calls):
    """One synthesis call per document, per line, or per blank-line paragraph
    (a trailing paragraph without a blank line is not synthesized)."""
    seen = []
    real = larynx_tpu_torch.text_to_speech

    def counting(*args, **kwargs):
        seen.append(kwargs["text"])
        return real(*args, **kwargs)

    monkeypatch.setattr(larynx_tpu_torch, "text_to_speech", counting)
    out = _run(cli, _args(cli_voices, *flags), capsysbinary, monkeypatch, stdin_text)
    assert out[:4] == b"RIFF"
    assert [s.strip() for s in seen] == [c.strip() for c in calls]


def test_cli_mark_file(cli_voices, tmp_path, capsysbinary):
    mark_file = tmp_path / "marks.txt"
    _run(cli, _args(cli_voices, '<speak>Before. <mark name="m1"/>After.</speak>', "--ssml",
                    "--mark-file", str(mark_file)), capsysbinary)
    assert mark_file.read_text().strip() == "m1"


def test_cli_list(capsys, cli_voices):
    with pytest.raises(SystemExit):
        cli.get_args(["--list", "--voices-dir", str(cli_voices)])
    out = capsys.readouterr().out
    assert "ljspeech-glow_tts" in out and "hifi_gan-universal_large" in out
    assert "torch_port_parity-glow_tts" in out and "hifi_gan-vctk_small" in out


def test_cli_module_entry_point():
    """``python -m larynx_tpu_torch`` runs as a module."""
    proc = subprocess.run([sys.executable, "-m", "larynx_tpu_torch", "--version"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == larynx_tpu_torch.__version__
