"""WaveGlow vocoder loader: a vocoder dir's ``config.json`` + ``generator.npz``.

Counterpart of ``larynx_tpu/waveglow.py`` for loading; vocoding runs in
``larynx_tpu_torch.runtime.engine``.  ``config.json`` holds the
``WaveGlowConfig`` fields at its top level, the sampling ``sigma`` among
them.  Only native ``.npz`` checkpoints load; the chunked long-utterance
``mels_to_audio`` surface is not ported.
"""

import typing
from pathlib import Path

import numpy as np

from larynx_tpu_torch.glow_tts import load_npz_checkpoint
from larynx_tpu_torch.models.waveglow.config import waveglow_config_from_json
from larynx_tpu_torch.weights import params_from_jax


def _refresh_inverses(tree):
    """Recompute every invertible-1x1 inverse from its weight: training
    only updates ``w``, so a checkpoint's stored inverse can be stale, and
    inference depends on it being exact."""
    for flow in tree.get("flows", []):
        conv = flow.get("convinv")
        if conv is not None and "w" in conv:
            conv["w_inv"] = np.linalg.inv(np.asarray(conv["w"]))
    return tree


class WaveGlowVocoder:
    """Vocoder: params (CPU tensors), config and sampling sigma."""

    def __init__(self, model_path: typing.Union[str, Path], backend=None):
        tree, raw_config = load_npz_checkpoint(Path(model_path), backend)
        self.model_config = waveglow_config_from_json(raw_config)
        self.sigma = self.model_config.sigma
        self.params = params_from_jax(_refresh_inverses(tree), "waveglow")
