"""HiFi-GAN vocoder loader: a vocoder dir's ``config.json`` + ``generator.npz``.

Counterpart of ``larynx_tpu/hifi_gan.py`` for loading; vocoding runs in
``larynx_tpu_torch.runtime.engine``.
"""

import typing
from pathlib import Path

from larynx_tpu_torch.glow_tts import load_npz_checkpoint
from larynx_tpu_torch.models.hifi_gan.config import hifi_gan_config_from_json
from larynx_tpu_torch.weights import params_from_jax


class HiFiGanVocoder:
    """Vocoder: params (CPU tensors) + config."""

    def __init__(self, model_path: typing.Union[str, Path], backend=None):
        tree, raw_config = load_npz_checkpoint(Path(model_path), backend)
        self.model_config = hifi_gan_config_from_json(raw_config)
        self.params = params_from_jax(tree, "hifi_gan")
