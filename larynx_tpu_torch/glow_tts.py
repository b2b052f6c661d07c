"""GlowTTS voice loader: a voice dir's ``config.json`` + ``generator.npz``.

Counterpart of ``larynx_tpu/glow_tts.py`` for loading; synthesis runs in
``larynx_tpu_torch.runtime.engine``.  Only native ``.npz`` checkpoints load:
``.pth`` / ``.onnx`` import is not ported.
"""

import json
import typing
from pathlib import Path

from larynx_tpu_torch.constants import InferenceBackend
from larynx_tpu_torch.convert.native import load_params
from larynx_tpu_torch.models.glow_tts.config import config_from_voice_json
from larynx_tpu_torch.weights import params_from_jax


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
    """Acoustic model of one voice: params (CPU tensors) + config."""

    def __init__(self, model_path: typing.Union[str, Path], backend=None):
        tree, self.raw_config = load_npz_checkpoint(Path(model_path), backend)
        self.model_config = config_from_voice_json(self.raw_config)
        self.params = params_from_jax(tree, "glow_tts")
        # set by the pipeline after loading
        self.phoneme_to_id: typing.Dict[str, int] = {}
        self.audio_settings = None
