"""GlowTTS voice: a voice dir's ``config.json`` + checkpoint, and the
per-model ``phonemes_to_mels`` surface.

Counterpart of ``larynx_tpu/glow_tts.py``.  Batched synthesis runs in
``larynx_tpu_torch.runtime.engine``; :meth:`GlowTextToSpeech.phonemes_to_mels`
runs one sentence through a mel-only engine (vocoder kind ``"none"``) on the
caller's device, for the unfused fallback.  Checkpoint preference, as in
``larynx_tpu``: native ``generator.npz`` > ``generator.pth`` (converted) >
``generator.onnx`` (converted).
"""

import typing
from pathlib import Path

import numpy as np

from larynx_tpu_torch.constants import InferenceBackend
from larynx_tpu_torch.convert import read_config, resolve_checkpoint
from larynx_tpu_torch.convert.native import load_params
from larynx_tpu_torch.device import resolve_device
from larynx_tpu_torch.models.glow_tts.config import config_from_voice_json
from larynx_tpu_torch.weights import PerDevice, params_from_jax


def load_glow_tts_artifacts(model_dir: Path, backend: typing.Optional[InferenceBackend] = None):
    """(native param tree, GlowTTSConfig, raw config dict) of a voice dir
    (``larynx_tpu/glow_tts.py::load_glow_tts_artifacts``)."""
    raw_config = read_config(model_dir)
    cfg = config_from_voice_json(raw_config)
    path = resolve_checkpoint(model_dir, backend, {
        InferenceBackend.JAX: [model_dir / "generator.npz"],
        InferenceBackend.PYTORCH: [model_dir / "generator.pth"],
        InferenceBackend.ONNX: [model_dir / "generator.onnx"],
    }, "No loadable checkpoint (generator.npz/.pth/.onnx)")
    if path.suffix == ".npz":
        return load_params(path), cfg, raw_config
    if path.suffix == ".pth":
        from larynx_tpu_torch.convert.torch_import import (
            glow_tts_params_from_state_dict,
            load_torch_state_dict,
        )

        sd = load_torch_state_dict(path, key="model")
        return glow_tts_params_from_state_dict(sd, cfg), cfg, raw_config
    from larynx_tpu_torch.convert.onnx_import import glow_tts_params_from_onnx

    return glow_tts_params_from_onnx(path, cfg), cfg, raw_config


class GlowTextToSpeech:
    """Acoustic model of one voice: params (CPU tensors) + config.  ``half``
    (bfloat16) is the precision of the model's own ``phonemes_to_mels``, as
    the JAX model's config sets it; its noise comes from the engine's seed."""

    def __init__(self, model_path: typing.Union[str, Path], backend=None, half: bool = False):
        tree, self.model_config, self.raw_config = load_glow_tts_artifacts(
            Path(model_path), backend)
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
