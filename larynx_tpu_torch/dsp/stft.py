"""Batched STFT / ISTFT with the reference's framing, as torch functions.

Counterpart of the parts of ``larynx_tpu/dsp/stft.py`` that the denoiser
uses.  The semantics differ from ``torch.stft``'s defaults on purpose:

  * the window is ``np.hanning`` (symmetric, endpoints 0), not the periodic
    ``torch.hann_window``;
  * framing is non-centred: frames start at ``range(0, T - fft, hop)``,
    so ``n_frames = ceil((T - fft) / hop)``;
  * synthesis applies the window again and overlap-adds without
    normalisation.

Signals are [B, T] float32; spectra are [B, n_freq, n_frames].
"""

import numpy as np
import torch


def hann_window(fft_size: int) -> np.ndarray:
    """numpy.hanning (N points, endpoints 0)."""
    return np.hanning(fft_size).astype(np.float32)


def num_frames(n_samples: int, fft_size: int, hop: int) -> int:
    """Frame count of the reference's framing loop."""
    span = n_samples - fft_size
    if span <= 0:
        return 0
    return -(-span // hop)


def frame_signal(x: torch.Tensor, fft_size: int, hop: int) -> torch.Tensor:
    """[B, T] -> [B, n_frames, fft_size]."""
    n = num_frames(x.shape[-1], fft_size, hop)
    return x.unfold(-1, fft_size, hop)[..., :n, :]


def stft_magnitude_phase(x: torch.Tensor, fft_size: int = 1024, hop: int = 256):
    """Batch magnitude and phase, each [B, n_freq, n_frames]."""
    window = torch.from_numpy(hann_window(fft_size)).to(x.device)
    spec = torch.fft.rfft(frame_signal(x, fft_size, hop) * window, dim=-1)
    spec = spec.transpose(-1, -2)
    return spec.abs(), torch.angle(spec)


def inverse_magnitude_phase(
    magnitude: torch.Tensor, phase: torch.Tensor, fft_size: int = 1024, hop: int = 256
) -> torch.Tensor:
    """Rebuild a waveform [B, n_frames * hop + fft] from magnitude + phase."""
    spec = torch.polar(magnitude, phase).transpose(-1, -2)  # [B, F, n_freq]
    frames = torch.fft.irfft(spec, n=fft_size, dim=-1)
    frames = frames * torch.from_numpy(hann_window(fft_size)).to(frames.device)
    b, n_frames, _ = frames.shape
    if n_frames == 0:
        return frames.new_zeros((b, fft_size))
    # un-normalised overlap-add of the windowed frames; the last hop of the
    # n_frames * hop + fft output is past every frame and stays zero
    span = (n_frames - 1) * hop + fft_size
    out = torch.nn.functional.fold(
        frames.transpose(1, 2),
        output_size=(1, span),
        kernel_size=(1, fft_size),
        stride=(1, hop),
    ).reshape(b, span)
    return torch.nn.functional.pad(out, (0, hop))
