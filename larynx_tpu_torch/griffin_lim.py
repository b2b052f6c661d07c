"""Griffin-Lim vocoder: no checkpoint, only the mel basis.

Counterpart of ``larynx_tpu/griffin_lim.py``.  ``get_vocoder_model
("griffin_lim")`` loads it; the batched path runs in
``larynx_tpu_torch.runtime.engine`` (vocoder kind ``"griffin_lim"``), and
:meth:`GriffinLimVocoder.mels_to_audio` vocodes one mel outside it for the
unfused fallback, on the caller's device.
"""

import itertools

import numpy as np
import torch

from larynx_tpu_torch.device import resolve_device
from larynx_tpu_torch.models.griffin_lim import GriffinLimState


class GriffinLimVocoder:
    """Griffin-Lim with the reference's settings (60 iterations, plain
    iteration, mel scaling 1000); each call draws its initial phase from
    the next seed of a counter."""

    def __init__(
        self,
        sample_rate: int = 22050,
        num_fft: int = 1024,
        num_mels: int = 80,
        mel_fmin: float = 0.0,
        mel_fmax: float = 8000.0,
        mel_scaling: float = 1000.0,
        iterations: int = 60,
    ):
        self.state = GriffinLimState(
            sample_rate=sample_rate,
            num_fft=num_fft,
            num_mels=num_mels,
            mel_fmin=mel_fmin,
            mel_fmax=mel_fmax,
            mel_scaling=mel_scaling,
            iterations=iterations,
        )
        # atomic under the GIL: concurrent calls never share a seed
        self._counter = itertools.count(1)

    @torch.inference_mode()
    def mels_to_audio(self, mels: np.ndarray, settings=None, device=None) -> np.ndarray:
        """Post-processed mels [1, n_mels, M] -> float32 audio
        [(M - 1) * hop + fft], on ``device`` (None: CUDA)."""
        device = resolve_device(device)
        mels = np.asarray(mels, dtype=np.float32)
        if mels.ndim == 2:
            mels = mels[None]
        generator = torch.Generator(device=device)
        generator.manual_seed(next(self._counter))
        audio = self.state(torch.from_numpy(mels).to(device), generator)
        return audio.cpu().numpy().squeeze(0)
