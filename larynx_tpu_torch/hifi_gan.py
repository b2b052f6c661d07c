"""HiFi-GAN vocoder: a vocoder dir's ``config.json`` + ``generator.npz``, and
the per-model ``mels_to_audio`` surface.

Counterpart of ``larynx_tpu/hifi_gan.py``.  The batched path runs in
``larynx_tpu_torch.runtime.engine``; :meth:`HiFiGanVocoder.mels_to_audio`
vocodes one post-processed mel outside it (the unfused fallback of
``larynx_tpu_torch._sentence_task_fallback``) through the same generator,
so a CUDA call launches the MRF kernel.
"""

import typing
from pathlib import Path

import numpy as np
import torch

from larynx_tpu_torch.audio import audio_float_to_int16
from larynx_tpu_torch.device import resolve_device
from larynx_tpu_torch.glow_tts import load_npz_checkpoint
from larynx_tpu_torch.models.hifi_gan import denoiser as hifi_denoiser
from larynx_tpu_torch.models.hifi_gan import model as hifi_model
from larynx_tpu_torch.models.hifi_gan.config import hifi_gan_config_from_json
from larynx_tpu_torch.runtime.buckets import BucketPolicy
from larynx_tpu_torch.runtime.engine import SILENCE_LOG_MEL, default_vocoder_half
from larynx_tpu_torch.weights import PerDevice, cast, params_from_jax, tree_to


def vocoder_dtype(half: bool, device: torch.device) -> torch.dtype:
    """The vocoder's dtype on ``device``: bfloat16 for ``half`` or where
    the engine's default is bf16 (CUDA), as ``_get_engine`` chooses."""
    return torch.bfloat16 if half or default_vocoder_half(device) else torch.float32


def pad_to_bucket(mels: np.ndarray, frames: int) -> np.ndarray:
    """[B, C, M] -> [B, C, frames], padded with the silence log-mel."""
    if frames > mels.shape[-1]:
        pad = np.full(mels.shape[:2] + (frames - mels.shape[-1],), SILENCE_LOG_MEL, np.float32)
        mels = np.concatenate([mels, pad], axis=-1)
    return mels


class HiFiGanVocoder:
    """Vocoder: params (CPU tensors) + config, and, per (device, dtype) that
    a ``mels_to_audio`` call used, the packed params and the denoiser bias.

    ``half`` and ``denoiser_strength`` are the defaults of the model's own
    calls, as ``larynx_tpu.get_vocoder_model`` sets them."""

    def __init__(self, model_path: typing.Union[str, Path], backend=None, half: bool = False,
                 denoiser_strength: float = 0.0):
        tree, raw_config = load_npz_checkpoint(Path(model_path), backend)
        self.model_config = hifi_gan_config_from_json(raw_config)
        self.params = params_from_jax(tree, "hifi_gan")
        self.mel_channels = self.model_config.num_mels
        self.half = half
        self.denoiser_strength = denoiser_strength
        self.policy = BucketPolicy()
        self._packed = PerDevice(lambda device, dtype: hifi_model.pack_params(
            cast(tree_to(self.params, device), dtype), self.model_config))
        self._bias = PerDevice(self._compute_bias_spec)

    def _generate(self, mels: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """mels [B, C, M] -> float32 audio [B, M * total_upsample]."""
        params = self._packed.get(mels.device, dtype)
        mel = mels.transpose(1, 2).contiguous().to(dtype)
        return hifi_model.generator(params, self.model_config, mel).float()

    @torch.inference_mode()
    def mels_to_audio(self, mels: np.ndarray, settings=None, device=None) -> np.ndarray:
        """Post-processed mels [1, n_mels, M] -> int16 audio [M * total_upsample]
        (plus the STFT tail with the denoiser), on ``device`` (None: CUDA).

        The mel is padded to its mel bucket with silence and the audio cut
        back to its frames; ``settings["denoiser_strength"]`` overrides the
        model's strength."""
        device = resolve_device(device)
        mels = np.asarray(mels, dtype=np.float32)
        if mels.ndim == 2:
            mels = mels[None]
        frames = mels.shape[-1]
        dtype = vocoder_dtype(self.half, device)
        padded = pad_to_bucket(mels, self.policy.mel_bucket(frames))
        audio = self._generate(torch.from_numpy(padded).to(device), dtype)
        audio = audio[:, : frames * self.model_config.total_upsample]

        strength = self.denoiser_strength
        if settings:
            strength = float(settings.get("denoiser_strength", strength))
        if strength > 0:
            audio = hifi_denoiser.denoise(audio, self.maybe_init_denoiser(device), strength)
        return audio_float_to_int16(audio.cpu().numpy()).squeeze()

    def maybe_init_denoiser(self, device=None) -> torch.Tensor:
        """The bias spectrum on ``device`` in the call's vocoder dtype: the
        first STFT frame's magnitude of the vocoder's output for an 88-frame
        zero mel, built once."""
        device = resolve_device(device)
        return self._bias.get(device, vocoder_dtype(self.half, device))

    @torch.inference_mode()
    def _compute_bias_spec(self, device, dtype) -> torch.Tensor:
        zeros = torch.zeros((1, self.mel_channels, hifi_denoiser.BIAS_MEL_FRAMES), device=device)
        return hifi_denoiser.compute_bias_spec(self._generate(zeros, dtype))
