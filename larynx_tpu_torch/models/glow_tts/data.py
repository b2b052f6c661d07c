"""Training data: WAV -> normalised log-mel targets, LJSpeech-style corpus,
padded batches.

Counterpart of ``larynx_tpu/models/glow_tts/data.py``.  The mel targets
are the inverse of the inference post-processing chain, computed with the
port's STFT on the dataset's device; batches have static shapes (ids
padded to ``max_id_len``, mels to ``max_mel_len``) and the same shuffle
order as the JAX package's for a seed.
"""

import csv
import typing
from pathlib import Path

import numpy as np
import torch

import larynx_tpu_torch.dsp.stft as dsp
from larynx_tpu_torch.audio import AudioSettings, mel_basis
from larynx_tpu_torch.device import to_device
from larynx_tpu_torch.io import wavfile
from larynx_tpu_torch.text.frontend import sentences as frontend_sentences
from larynx_tpu_torch.text.ids import phonemes_to_ids


def _pcm_to_float(pcm: np.ndarray) -> np.ndarray:
    """Any ``wavfile.read`` dtype (uint8 centred at 128, int16, int32 or
    float) -> float32 in [-1, 1]."""
    if pcm.dtype == np.uint8:
        return (pcm.astype(np.float32) - 128.0) / 128.0
    if pcm.dtype == np.int16:
        return pcm.astype(np.float32) / 32768.0
    if pcm.dtype == np.int32:
        return pcm.astype(np.float32) / 2147483648.0
    return pcm.astype(np.float32)


def mel_basis_tensor(settings: AudioSettings, device) -> torch.Tensor:
    """The settings' mel filter bank [n_mels, n_freq] on ``device``."""
    return to_device(mel_basis(settings.sample_rate, settings.filter_length,
                               settings.mel_channels, settings.mel_fmin, settings.mel_fmax),
                     device)


def mel_targets(audio: torch.Tensor, settings: AudioSettings, basis: torch.Tensor) -> torch.Tensor:
    """waveform [B, T] -> normalised log-mel [B, M, n_mels], what the model
    learns to emit: ``normalize(amp_to_db(mel_amp))``, so that the
    inference chain (denormalize -> db_to_amp -> log) gives the vocoder's
    input back."""
    mag, _ = dsp.stft_magnitude_phase(audio, settings.filter_length, settings.hop_length)
    mel_amp = torch.einsum("mf,bft->bmt", basis, mag)
    mel_db = settings.spec_gain * torch.log10(torch.clamp(mel_amp, min=1e-5))
    if settings.signal_norm:
        norm = ((mel_db - settings.ref_level_db) - settings.min_level_db) / (-settings.min_level_db)
        if settings.symmetric_norm:
            norm = (2 * settings.max_norm) * norm - settings.max_norm
            if settings.clip_norm:
                norm = torch.clamp(norm, -settings.max_norm, settings.max_norm)
        else:
            norm = settings.max_norm * norm
            if settings.clip_norm:
                norm = torch.clamp(norm, 0, settings.max_norm)
        mel_db = norm
    return mel_db.transpose(1, 2)


class Dataset:
    """LJSpeech-style corpus: ``metadata.csv`` (id|text) + ``wavs/<id>.wav``;
    mel targets are computed on ``device``."""

    def __init__(
        self,
        csv_path: typing.Union[str, Path],
        wav_dir: typing.Union[str, Path],
        phoneme_to_id: typing.Mapping[str, int],
        settings: AudioSettings,
        lang: str = "en-us",
        device: typing.Union[str, torch.device] = "cpu",
    ):
        self.wav_dir = Path(wav_dir)
        self.phoneme_to_id = dict(phoneme_to_id)
        self.settings = settings
        self.lang = lang
        self.device = torch.device(device)
        self.basis = mel_basis_tensor(settings, self.device)
        self.items: typing.List[typing.Tuple[str, str]] = []
        with open(csv_path, encoding="utf-8") as f:
            for row in csv.reader(f, delimiter="|"):
                if len(row) >= 2:
                    self.items.append((row[0], row[-1]))

    def __len__(self) -> int:
        return len(self.items)

    def example(self, index: int):
        """-> (ids [T] int32, mel [M, n_mels] float32) as numpy, or None for
        a missing wav or a text with no phonemes."""
        utt_id, text = self.items[index]
        wav_path = self.wav_dir / f"{utt_id}.wav"
        if not wav_path.is_file():
            return None
        _rate, pcm = wavfile.read(wav_path)
        if pcm.ndim > 1:
            pcm = pcm[:, 0]
        all_ids: typing.List[int] = []
        for sent in frontend_sentences(text, lang=self.lang):
            word_phonemes = [w.phonemes for w in sent if w.phonemes]
            all_ids.extend(phonemes_to_ids(word_phonemes, self.phoneme_to_id))
        if not all_ids:
            return None
        audio = to_device(_pcm_to_float(pcm), self.device)
        mel = mel_targets(audio[None, :], self.settings, self.basis)[0]
        return np.asarray(all_ids, dtype=np.int32), mel.cpu().numpy()

    def batches(
        self,
        batch_size: int,
        max_id_len: int = 192,
        max_mel_len: int = 1024,
        shuffle_seed: typing.Optional[int] = None,
        drop_invalid: bool = True,
    ) -> typing.Iterator[typing.Dict[str, np.ndarray]]:
        """Padded batches of ``batch_size`` examples, in the order of
        ``default_rng(shuffle_seed)``'s shuffle; an example longer than the
        padding is dropped, and so is the last, partial batch."""
        order = np.arange(len(self.items))
        if shuffle_seed is not None:
            np.random.default_rng(shuffle_seed).shuffle(order)
        buf: typing.List[typing.Tuple[np.ndarray, np.ndarray]] = []
        for index in order:
            ex = self.example(int(index))
            if ex is None:
                continue
            ids, mel = ex
            if drop_invalid and (len(ids) > max_id_len or mel.shape[0] > max_mel_len):
                continue
            buf.append((ids, mel))
            if len(buf) == batch_size:
                yield self._pad_batch(buf, max_id_len, max_mel_len)
                buf = []

    def _pad_batch(self, items, max_id_len, max_mel_len) -> typing.Dict[str, np.ndarray]:
        b = len(items)
        ids = np.zeros((b, max_id_len), dtype=np.int32)
        id_lengths = np.zeros((b,), dtype=np.int32)
        mels = np.zeros((b, max_mel_len, self.settings.mel_channels), dtype=np.float32)
        mel_lengths = np.zeros((b,), dtype=np.int32)
        for i, (seq, mel) in enumerate(items):
            ids[i, : len(seq)] = seq
            id_lengths[i] = len(seq)
            m = min(mel.shape[0], max_mel_len)
            mels[i, :m] = mel[:m]
            mel_lengths[i] = m
        return {"ids": ids, "id_lengths": id_lengths, "mels": mels, "mel_lengths": mel_lengths}
