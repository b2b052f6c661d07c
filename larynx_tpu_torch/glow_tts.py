"""GlowTTS voice: a voice dir's ``config.json`` + ``generator.npz``, and the
per-model ``phonemes_to_mels`` surface.

Counterpart of ``larynx_tpu/glow_tts.py``.  Batched synthesis runs in
``larynx_tpu_torch.runtime.engine``; :meth:`GlowTextToSpeech.phonemes_to_mels`
runs one sentence through a mel-only engine (vocoder kind ``"none"``) on the
caller's device, for the unfused fallback.  Only native ``.npz`` checkpoints
load: ``.pth`` / ``.onnx`` import is not ported.
"""

import json
import typing
from pathlib import Path

import numpy as np

from larynx_tpu_torch.constants import InferenceBackend
from larynx_tpu_torch.device import resolve_device
from larynx_tpu_torch.convert.native import load_params
from larynx_tpu_torch.models.glow_tts.config import config_from_voice_json
from larynx_tpu_torch.weights import PerDevice, params_from_jax


def load_npz_checkpoint(model_dir: Path, backend: typing.Optional[InferenceBackend]):
    """(native param tree, raw config dict) of a voice or vocoder dir."""
    if backend not in (None, InferenceBackend.JAX):
        raise NotImplementedError(f"backend {backend!r}: only .npz checkpoints load")
    with open(model_dir / "config.json", "r", encoding="utf-8") as f:
        raw_config = json.load(f)
    npz_path = model_dir / "generator.npz"
    if not npz_path.is_file():
        raise NotImplementedError(
            f"{model_dir} has no generator.npz; .pth/.onnx import is not ported"
        )
    return load_params(npz_path), raw_config


class GlowTextToSpeech:
    """Acoustic model of one voice: params (CPU tensors) + config.  ``half``
    (bfloat16) is the precision of the model's own ``phonemes_to_mels``, as
    the JAX model's config sets it; its noise comes from the engine's seed."""

    def __init__(self, model_path: typing.Union[str, Path], backend=None, half: bool = False):
        tree, self.raw_config = load_npz_checkpoint(Path(model_path), backend)
        self.model_config = config_from_voice_json(self.raw_config)
        self.params = params_from_jax(tree, "glow_tts")
        self.half = half
        self.noise_scale = 0.667
        self.length_scale = 1.0
        # one mel-only engine per device, built at its first call
        self._engines = PerDevice(self._make_engine)
        # set by the pipeline after loading
        self.phoneme_to_id: typing.Dict[str, int] = {}
        self.audio_settings = None

    def _make_engine(self, device, _dtype):
        from larynx_tpu_torch.audio import AudioSettings
        from larynx_tpu_torch.runtime.engine import SynthesisEngine

        return SynthesisEngine(
            self.params, self.model_config, self.audio_settings or AudioSettings(),
            vocoder_kind="none", device=device, half=self.half,
        )

    def phonemes_to_mels(self, phoneme_ids: np.ndarray, settings=None, device=None) -> np.ndarray:
        """ids [T] or [1, T] -> normalised mels [1, n_mels, frames] (numpy),
        on ``device`` (None: CUDA); ``settings`` may set ``noise_scale``,
        ``length_scale`` and, for a multi-speaker voice, ``speaker_id``."""
        noise_scale, length_scale = self.noise_scale, self.length_scale
        speaker_id = None
        if settings:
            noise_scale = float(settings.get("noise_scale", noise_scale))
            length_scale = float(settings.get("length_scale", length_scale))
            speaker_id = settings.get("speaker_id", None)
        ids = np.asarray(phoneme_ids)
        if ids.ndim == 2:
            ids = ids[0]
        engine = self._engines.get(resolve_device(device), None)
        return engine.phonemes_to_mels(ids, noise_scale=noise_scale, length_scale=length_scale,
                                       speaker_id=speaker_id)
