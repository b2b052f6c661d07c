"""Tacotron2 voice: a voice dir's ``config.json`` + checkpoint, and the
per-model ``phonemes_to_mels`` surface.

Counterpart of ``larynx_tpu/tacotron2.py``.  Checkpoint preference, as in
``larynx_tpu``: native ``generator.npz`` > ``generator.pth`` (NVIDIA
layout, converted).  The entry points reach the voice through the engine
(``runtime/tacotron2_engine.py``), which decodes a batch's rows at once;
``phonemes_to_mels`` is the model's own surface and the stream's (the
unfused fallback, ``_sentence_task_fallback``).  Phoneme ids are padded to a
text bucket, and the bucket caps the decode's steps at
:func:`step_budget`, ``min(max_decoder_steps, 10 * bucket)``, the length of
a row whose gate never fires.  The decode ends early once every row has
stopped (``models/tacotron2/model.py::decode_blocked``).
"""

import typing
from pathlib import Path

import numpy as np
import torch

from larynx_tpu_torch.constants import InferenceBackend
from larynx_tpu_torch.convert import read_config, resolve_checkpoint
from larynx_tpu_torch.convert.native import load_params
from larynx_tpu_torch.device import resolve_device, to_device
from larynx_tpu_torch.models.tacotron2 import model as t2_model
from larynx_tpu_torch.models.tacotron2.config import tacotron2_config_from_voice_json
from larynx_tpu_torch.weights import PerDevice, params_from_jax, tree_to

_TEXT_BUCKETS = (16, 32, 64, 96, 128, 192, 256, 384)
# decoder-step budget per encoder token (~87 frames/s at 256-hop 22kHz;
# generous so the gate, not the cap, normally ends the decode)
_MAX_FRAMES_PER_TOKEN = 10
# the prenet masks' seed when the call's settings give none
_DEFAULT_SEED = 1234


def text_bucket(t: int) -> int:
    """The padded width of ``t`` phoneme ids (``t`` itself past the last bucket)."""
    return next((b for b in _TEXT_BUCKETS if b >= t), t)


def step_budget(cfg, n_ids: int, max_decoder_steps: typing.Optional[int] = None) -> int:
    """The decoder steps a sentence of ``n_ids`` ids may run:
    ``min(max_decoder_steps, 10 * its text bucket)``, ``max_decoder_steps``
    the config's unless given."""
    if max_decoder_steps is None:
        max_decoder_steps = cfg.max_decoder_steps
    return min(int(max_decoder_steps), _MAX_FRAMES_PER_TOKEN * text_bucket(n_ids))


def load_tacotron2_artifacts(model_dir: Path, backend: typing.Optional[InferenceBackend] = None):
    """(native param tree, Tacotron2Config, raw config dict) of a voice dir
    (``larynx_tpu/tacotron2.py::load_tacotron2_artifacts``)."""
    raw_config = read_config(model_dir)
    cfg = tacotron2_config_from_voice_json(raw_config)
    path = resolve_checkpoint(model_dir, backend, {
        InferenceBackend.JAX: [model_dir / "generator.npz"],
        InferenceBackend.PYTORCH: [model_dir / "generator.pth"],
    }, "No loadable checkpoint (generator.npz/.pth)")
    if path.suffix == ".npz":
        return load_params(path), cfg, raw_config
    from larynx_tpu_torch.convert.torch_import import (
        load_torch_state_dict,
        tacotron2_params_from_state_dict,
    )

    sd = load_torch_state_dict(path, key="state_dict")
    return tacotron2_params_from_state_dict(sd, cfg), cfg, raw_config


class Tacotron2TextToSpeech:
    """Acoustic model of one Tacotron2 voice: params (CPU tensors) + config,
    and the params per device that a call used.  ``half`` is stored and the
    model runs in float32, as the JAX wrapper runs it; the vocoder's
    precision follows ``half`` as for any voice."""

    def __init__(self, model_path: typing.Union[str, Path], backend=None, half: bool = False):
        tree, self.model_config, self.raw_config = load_tacotron2_artifacts(
            Path(model_path), backend)
        self.params = params_from_jax(tree, "tacotron2")
        self.half = half
        self._device_params = PerDevice(lambda device, _dtype: t2_model.pack_params(
            tree_to(self.params, device), self.model_config))
        # set by the pipeline after loading
        self.phoneme_to_id: typing.Dict[str, int] = {}
        self.audio_settings = None

    @torch.inference_mode()
    def phonemes_to_mels(self, phoneme_ids: np.ndarray, settings=None, device=None) -> np.ndarray:
        """ids [T] or [B, T] -> mels [B, n_mels, S] (float32 numpy) on
        ``device`` (None: CUDA), cropped at the longest row's stop frame.
        ``settings`` may set ``max_decoder_steps`` and ``seed`` (the prenet
        dropout's masks, :func:`models.tacotron2.model.draw_keep_masks`)."""
        device = resolve_device(device)
        cfg = self.model_config
        max_decoder_steps = None
        seed = _DEFAULT_SEED
        if settings:
            max_decoder_steps = settings.get("max_decoder_steps")
            seed = int(settings.get("seed", seed))

        ids = np.asarray(phoneme_ids)
        if ids.ndim == 1:
            ids = ids[None, :]
        bsz, t = ids.shape
        t_bucket = text_bucket(t)
        padded = np.zeros((bsz, t_bucket), dtype=np.int64)
        padded[:, :t] = ids
        max_steps = step_budget(cfg, t, max_decoder_steps)
        keep_masks = None
        if cfg.p_prenet_dropout > 0.0:  # draw_keep_masks's rows, a block at a time
            keep_masks = t2_model.RowKeepMasks(cfg, [[seed, r] for r in range(bsz)], device)

        params = self._device_params.get(device, torch.float32)
        memory, mask = t2_model.encode(params, cfg, to_device(padded, device),
                                       to_device(np.full((bsz,), t, dtype=np.int32), device))
        mels, lengths, _steps, _blocks = t2_model.decode_blocked(
            params, cfg, memory, mask, np.full((bsz,), max_steps), keep_masks)
        mel = mels + t2_model.postnet(params, cfg, mels)
        n = max(int(lengths.max()), 1)
        return np.ascontiguousarray(mel[:, :n].cpu().numpy().transpose(0, 2, 1))
