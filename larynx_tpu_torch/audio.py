# Copied from larynx_tpu/audio.py; only the package name in its imports differs.
"""Audio settings and host-side DSP helpers.

Numpy implementations of the mel (de)normalization contract the voice
configs rely on (reference semantics: larynx/audio.py:25-161).  The
device-side (JAX) equivalents used inside jitted synthesis graphs live in
:mod:`larynx_tpu.dsp`; both must agree bit-for-bit in float32 on the
denormalize -> db_to_amp -> dynamic-range-compression chain applied between
the acoustic model and the vocoder (larynx/__init__.py:242-249).
"""

import typing
from dataclasses import dataclass

import numpy as np

# -----------------------------------------------------------------------------


@dataclass
class AudioSettings:
    """STFT geometry + mel normalization flags for one voice.

    Field names/defaults mirror the per-voice ``config.json`` ``audio``
    section (reference: larynx/audio.py:25-49) so configs load unchanged.
    """

    # STFT settings
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 256
    mel_channels: int = 80
    sample_rate: int = 22050
    sample_bytes: int = 2
    channels: int = 1
    mel_fmin: float = 0.0
    mel_fmax: typing.Optional[float] = 8000.0
    ref_level_db: float = 20.0
    spec_gain: float = 1.0

    # Normalization
    signal_norm: bool = False
    min_level_db: float = -100.0
    max_norm: float = 4.0
    clip_norm: bool = True
    symmetric_norm: bool = True
    do_dynamic_range_compression: bool = True
    convert_db_to_amp: bool = True

    # --- dB <-> amplitude (larynx/audio.py:55-59) ---

    def amp_to_db(self, mel_amp: np.ndarray) -> np.ndarray:
        return self.spec_gain * np.log10(np.maximum(1e-5, mel_amp))

    def db_to_amp(self, mel_db: np.ndarray) -> np.ndarray:
        return np.power(10.0, mel_db / self.spec_gain)

    # --- normalization (larynx/audio.py:65-104) ---

    def normalize(self, mel_db: np.ndarray) -> np.ndarray:
        """Map dB mels into [0, max_norm] or [-max_norm, max_norm]."""
        norm = ((mel_db - self.ref_level_db) - self.min_level_db) / (
            -self.min_level_db
        )
        if self.symmetric_norm:
            norm = (2 * self.max_norm) * norm - self.max_norm
            if self.clip_norm:
                norm = np.clip(norm, -self.max_norm, self.max_norm)
        else:
            norm = self.max_norm * norm
            if self.clip_norm:
                norm = np.clip(norm, 0, self.max_norm)
        return norm

    def denormalize(self, mel_norm: np.ndarray) -> np.ndarray:
        """Inverse of :meth:`normalize`."""
        if self.symmetric_norm:
            if self.clip_norm:
                mel_norm = np.clip(mel_norm, -self.max_norm, self.max_norm)
            mel_db = (
                (mel_norm + self.max_norm)
                * -self.min_level_db
                / (2 * self.max_norm)
            ) + self.min_level_db
        else:
            if self.clip_norm:
                mel_norm = np.clip(mel_norm, 0, self.max_norm)
            mel_db = (
                mel_norm * -self.min_level_db / self.max_norm
            ) + self.min_level_db
        return mel_db + self.ref_level_db

    # --- dynamic range (larynx/audio.py:106-112) ---

    def dynamic_range_compression(self, x, C=1, clip_val=1e-5):
        return np.log(np.clip(x, a_min=clip_val, a_max=None) * C)

    def dynamic_range_decompression(self, x, C=1):
        return np.exp(x) / C


# -----------------------------------------------------------------------------


def audio_float_to_int16(
    audio: np.ndarray, max_wav_value: float = 32767.0
) -> np.ndarray:
    """Peak-normalize float audio into int16 (larynx/audio.py:118-125)."""
    peak = max(0.01, float(np.max(np.abs(audio))) if audio.size else 0.01)
    scaled = audio * (max_wav_value / peak)
    return np.clip(scaled, -max_wav_value, max_wav_value).astype(np.int16)


# -----------------------------------------------------------------------------
# Slaney-normalized mel filter bank (librosa-compatible; larynx/audio.py:131-229)


def hz_to_mel(frequencies: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = frequencies / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    if mels.ndim:
        hi = frequencies >= min_log_hz
        mels[hi] = min_log_mel + np.log(frequencies[hi] / min_log_hz) / logstep
    elif frequencies >= min_log_hz:
        mels = min_log_mel + np.log(frequencies / min_log_hz) / logstep
    return mels


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asanyarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    if mels.ndim:
        hi = mels >= min_log_mel
        freqs[hi] = min_log_hz * np.exp(logstep * (mels[hi] - min_log_mel))
    elif mels >= min_log_mel:
        freqs = min_log_hz * np.exp(logstep * (mels - min_log_mel))
    return freqs


def mel_frequencies(n_mels: int = 128, fmin: float = 0.0, fmax: float = 11025.0):
    return mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels))


def fft_frequencies(sr: int = 22050, n_fft: int = 2048) -> np.ndarray:
    return np.linspace(0, float(sr) / 2, 1 + n_fft // 2, endpoint=True)


def mel_basis(
    sr: int,
    n_fft: int,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: typing.Optional[float] = None,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filter bank [n_mels, 1 + n_fft//2], Slaney-normalized."""
    if fmax is None:
        fmax = float(sr) / 2

    fftfreqs = fft_frequencies(sr=sr, n_fft=n_fft)
    mel_f = mel_frequencies(int(n_mels) + 2, fmin=fmin, fmax=fmax)
    fdiff = np.diff(mel_f)
    # ramps[i, k] = mel_f[i] - fftfreqs[k]
    ramps = mel_f[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney normalization: approximately constant energy per channel
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(dtype)
