"""HiFi-GAN bias denoiser (spectral subtraction) on the device.

Counterpart of ``larynx_tpu/models/hifi_gan/denoiser.py``: the vocoder's
bias signature comes from vocoding an 88-frame zero mel; the first STFT
frame's magnitude of that bias audio, scaled by the strength, is subtracted
from the output's magnitude, clipped at zero, and the waveform rebuilt with
the original phase.  The spectra are float32 whatever the vocoder's dtype:
bfloat16 audio is widened before its STFT.
"""

import torch

import larynx_tpu_torch.dsp.stft as dsp

BIAS_MEL_FRAMES = 88


def compute_bias_spec(
    bias_audio: torch.Tensor, fft_size: int = 1024, hop: int = 256
) -> torch.Tensor:
    """bias audio [B, T] -> first-frame magnitude spectrum [B, n_freq, 1]."""
    mag, _ = dsp.stft_magnitude_phase(bias_audio.float(), fft_size, hop)
    return mag[:, :, 0:1]


def denoise(
    audio: torch.Tensor,
    bias_spec: torch.Tensor,
    strength,
    fft_size: int = 1024,
    hop: int = 256,
    n_frames=None,
) -> torch.Tensor:
    """audio [B, T]; bias_spec [B or 1, n_freq, 1]; strength scalar or [B, 1, 1].
    ``n_frames`` [B] (None: every frame) drops each row's STFT frames from
    its ``n_frames``-th on: the row's output is then that of the row cut,
    before the STFT, to a length of ``n_frames`` frames."""
    mag, phase = dsp.stft_magnitude_phase(audio.float(), fft_size, hop)
    mag = torch.clamp(mag - bias_spec * strength, min=0.0)
    if n_frames is not None:
        kept = torch.arange(mag.shape[-1], device=mag.device)[None, :] < n_frames[:, None]
        mag = mag * kept[:, None, :]
    return dsp.inverse_magnitude_phase(mag, phase, fft_size, hop)
