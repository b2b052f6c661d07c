"""Batched STFT / ISTFT and Griffin-Lim with the reference's framing, as
torch functions.

Counterpart of ``larynx_tpu/dsp/stft.py`` on its FFT branch (the matmul DFT
that the JAX package takes on a TPU is not ported).  The semantics differ
from ``torch.stft``'s defaults on purpose:

  * the window is ``np.hanning`` (symmetric, endpoints 0), not the periodic
    ``torch.hann_window``;
  * framing is non-centred: frames start at ``range(0, T - fft, hop)``,
    so ``n_frames = ceil((T - fft) / hop)``;
  * synthesis applies the window again and overlap-adds without
    normalisation, into ``n_frames * hop + fft`` samples.

Signals are [B, T] float32; spectra are [B, n_freq, n_frames].
"""

import math
import typing

import numpy as np
import torch

from larynx_tpu_torch.device import to_device


def hann_window(fft_size: int) -> np.ndarray:
    """numpy.hanning (N points, endpoints 0)."""
    return np.hanning(fft_size).astype(np.float32)


def _window(fft_size: int, device) -> torch.Tensor:
    return to_device(hann_window(fft_size), device)


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


def _stft_frames(x: torch.Tensor, fft_size: int, hop: int) -> torch.Tensor:
    """Complex STFT, frames-major: [B, T] -> [B, n_frames, n_freq]."""
    return torch.fft.rfft(frame_signal(x, fft_size, hop) * _window(fft_size, x.device), dim=-1)


def stft_magnitude_phase(x: torch.Tensor, fft_size: int = 1024, hop: int = 256):
    """Batch magnitude and phase, each [B, n_freq, n_frames]."""
    spec = _stft_frames(x, fft_size, hop).transpose(-1, -2)
    return spec.abs(), torch.angle(spec)


def istft_overlap_add(frames: torch.Tensor, fft_size: int, hop: int, out_len: int) -> torch.Tensor:
    """Windowed overlap-add of time-domain frames [B, F, fft] -> [B, out_len]:
    the Hann window applied again and no COLA normalisation, as the
    reference's synthesis; samples past ``out_len`` are dropped and those
    past every frame are zero."""
    frames = frames * _window(fft_size, frames.device)
    b, n_frames, _ = frames.shape
    if n_frames == 0:
        return frames.new_zeros((b, out_len))
    span = (n_frames - 1) * hop + fft_size
    out = torch.nn.functional.fold(
        frames.transpose(1, 2),
        output_size=(1, span),
        kernel_size=(1, fft_size),
        stride=(1, hop),
    ).reshape(b, span)
    if span >= out_len:
        return out[:, :out_len]
    return torch.nn.functional.pad(out, (0, out_len - span))


def _istft_frames(spec_frames: torch.Tensor, fft_size: int, hop: int) -> torch.Tensor:
    """Inverse STFT from a frames-major complex spectrum [B, n_frames, n_freq]
    -> [B, n_frames * hop + fft]: every frame lands in its slot."""
    frames = torch.fft.irfft(spec_frames, n=fft_size, dim=-1)
    return istft_overlap_add(frames, fft_size, hop, frames.shape[1] * hop + fft_size)


def istft(spec: torch.Tensor, fft_size: int = 1024, hop: int = 256) -> torch.Tensor:
    """Inverse STFT: complex [B, n_freq, n_frames] -> [B, n_frames * hop + fft]."""
    return _istft_frames(spec.transpose(-1, -2), fft_size, hop)


def inverse_magnitude_phase(
    magnitude: torch.Tensor, phase: torch.Tensor, fft_size: int = 1024, hop: int = 256
) -> torch.Tensor:
    """Rebuild a waveform [B, n_frames * hop + fft] from magnitude + phase."""
    return istft(torch.polar(magnitude, phase), fft_size, hop)


def phase_project_frames(
    mag_frames: torch.Tensor, signal: torch.Tensor, fft_size: int, hop: int
) -> torch.Tensor:
    """One Griffin-Lim projection with frames-major magnitudes
    [B, n_frames, n_freq]: the signal's STFT phase as X / |X| (with the JAX
    function's 1e-12 under the root) on the target magnitudes, back to a
    signal."""
    spec = _stft_frames(signal, fft_size, hop)
    real, imag = spec.real, spec.imag
    inv_mag = torch.rsqrt(real * real + imag * imag + 1e-12)
    projected = torch.complex(mag_frames * real * inv_mag, mag_frames * imag * inv_mag)
    return _istft_frames(projected, fft_size, hop)


def phase_project(
    magnitudes: torch.Tensor, signal: torch.Tensor, fft_size: int, hop: int
) -> torch.Tensor:
    """Griffin-Lim projection, freq-major magnitudes [B, n_freq, n_frames]."""
    return phase_project_frames(magnitudes.transpose(-1, -2), signal, fft_size, hop)


def griffin_lim(
    magnitudes: torch.Tensor,
    generator: typing.Optional[torch.Generator] = None,
    fft_size: int = 1024,
    hop: int = 256,
    n_iters: int = 60,
    initial_phase: typing.Optional[torch.Tensor] = None,
    momentum: float = 0.0,
) -> torch.Tensor:
    """Griffin-Lim phase reconstruction of linear magnitudes
    [B, n_freq, n_frames] -> [B, n_frames * hop + fft], on the magnitudes'
    device (``larynx_tpu/dsp/stft.py::griffin_lim``).

    The phase starts from ``initial_phase`` when given, else uniformly in
    [0, 2 pi) from ``generator``.  ``momentum`` > 0 is Fast Griffin-Lim
    (Perraudin et al.): t_{n+1} = c_n + momentum * (c_n - c_{n-1}) with
    c_n = project(t_n), returning the last projection c; 0 is the
    reference's plain iteration."""
    if initial_phase is None:
        initial_phase = 2.0 * math.pi * torch.rand(
            magnitudes.shape, generator=generator, device=magnitudes.device, dtype=torch.float32
        )
    signal = inverse_magnitude_phase(magnitudes, initial_phase, fft_size, hop)
    mag_frames = magnitudes.transpose(-1, -2)  # the loop runs frames-major
    if not momentum:
        for _ in range(n_iters):
            signal = phase_project_frames(mag_frames, signal, fft_size, hop)
        return signal
    t, prev_c = signal, signal
    for _ in range(n_iters):
        c = phase_project_frames(mag_frames, t, fft_size, hop)
        t, prev_c = c + momentum * (c - prev_c), c
    return prev_c
