"""Griffin-Lim vocoder: mel -> waveform on the device.

Counterpart of ``larynx_tpu/models/griffin_lim.py``: dynamic-range
decompress, project the mel to linear magnitudes through the transposed mel
basis, scale by 1000, drop the last frame, then 60 iterations of phase
re-estimation (``dsp.stft.griffin_lim``), all as tensor code on the mel's
device.  No kernel of the JAX package covers it: there it is ``jnp.fft``
under ``lax.fori_loop``, here ``torch.fft`` in a Python loop.
"""

import typing

import torch

import larynx_tpu_torch.dsp.mel as dspmel
import larynx_tpu_torch.dsp.stft as dsp
from larynx_tpu_torch.audio import mel_basis as make_mel_basis


def mels_to_audio(
    mels: torch.Tensor,
    basis: torch.Tensor,
    generator: typing.Optional[torch.Generator] = None,
    initial_phase: typing.Optional[torch.Tensor] = None,
    mel_scaling: float = 1000.0,
    fft_size: int = 1024,
    hop: int = 256,
    n_iters: int = 60,
) -> torch.Tensor:
    """mels [B, n_mels, T] (dynamic-range compressed) -> audio
    [B, (T - 1) * hop + fft].  ``basis`` is the [n_mels, n_freq] Slaney mel
    filter bank on the mels' device.  The phase starts from
    ``initial_phase`` if given, else at random from ``generator``."""
    spec = dspmel.linear_from_mel(mels, basis, mel_scaling)[:, :, :-1]  # the reference drops the last frame
    return dsp.griffin_lim(spec, generator, fft_size, hop, n_iters, initial_phase=initial_phase)


class GriffinLimState:
    """The mel basis (numpy, moved to a call's device) and the loop's settings."""

    def __init__(
        self,
        sample_rate: int = 22050,
        num_fft: int = 1024,
        num_mels: int = 80,
        mel_fmin: float = 0.0,
        mel_fmax: float = 8000.0,
        mel_scaling: float = 1000.0,
        iterations: int = 60,
        hop: int = 256,
    ):
        self.basis = torch.from_numpy(
            make_mel_basis(sample_rate, num_fft, num_mels, mel_fmin, mel_fmax)
        )
        self.mel_scaling = mel_scaling
        self.iterations = iterations
        self.num_fft = num_fft
        self.hop = hop

    def __call__(self, mels: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return mels_to_audio(
            mels,
            self.basis.to(mels.device),
            generator=generator,
            mel_scaling=self.mel_scaling,
            fft_size=self.num_fft,
            hop=self.hop,
            n_iters=self.iterations,
        )
