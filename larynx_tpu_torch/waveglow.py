"""WaveGlow vocoder: a vocoder dir's ``config.json`` + checkpoint
(``generator.npz`` > every ``*.pth`` then ``*.pt``, sorted, as in
``larynx_tpu``; no ``.onnx``), and the per-model ``mels_to_audio`` surface
with chunked long-utterance vocoding.

Counterpart of ``larynx_tpu/waveglow.py``.  The batched path runs in
``larynx_tpu_torch.runtime.engine``; :meth:`WaveGlowVocoder.mels_to_audio`
vocodes one post-processed mel outside it (the unfused fallback, which is
how WaveGlow streams) through the same ``infer``, so a CUDA call launches
the WN kernel.  ``config.json`` holds the ``WaveGlowConfig`` fields at its
top level, the sampling ``sigma`` among them.
"""

import itertools
import typing
from pathlib import Path

import numpy as np
import torch

from larynx_tpu_torch.audio import audio_float_to_int16
from larynx_tpu_torch.constants import InferenceBackend
from larynx_tpu_torch.convert import read_config, resolve_checkpoint
from larynx_tpu_torch.convert.native import load_params
from larynx_tpu_torch.device import resolve_device
from larynx_tpu_torch.hifi_gan import pad_to_bucket, vocoder_dtype
from larynx_tpu_torch.models.hifi_gan import denoiser as hifi_denoiser
from larynx_tpu_torch.models.waveglow import model as wg_model
from larynx_tpu_torch.models.waveglow.config import WaveGlowConfig, waveglow_config_from_json
from larynx_tpu_torch.runtime.buckets import BucketPolicy
from larynx_tpu_torch.weights import PerDevice, cast, params_from_jax, tree_to


def _refresh_inverses(tree):
    """Recompute every invertible-1x1 inverse from its weight: training
    only updates ``w``, so a checkpoint's stored inverse can be stale, and
    inference depends on it being exact."""
    for flow in tree.get("flows", []):
        conv = flow.get("convinv")
        if conv is not None and "w" in conv:
            conv["w_inv"] = np.linalg.inv(np.asarray(conv["w"]))
    return tree


def load_waveglow_artifacts(
    model_dir: Path, backend: typing.Optional[InferenceBackend] = None
) -> typing.Tuple[typing.Any, WaveGlowConfig]:
    """(native param tree, WaveGlowConfig) of a vocoder dir
    (``larynx_tpu/waveglow.py::load_waveglow_artifacts``): an ``.npz`` gets
    its inverses recomputed; a state dict (key ``"model"``) converts with
    them."""
    cfg = waveglow_config_from_json(read_config(model_dir))
    path = resolve_checkpoint(model_dir, backend, {
        InferenceBackend.JAX: [model_dir / "generator.npz"],
        InferenceBackend.PYTORCH: sorted(model_dir.glob("*.pth")) + sorted(model_dir.glob("*.pt")),
    }, "No loadable WaveGlow checkpoint (generator.npz/*.pth)")
    if path.suffix == ".npz":
        return _refresh_inverses(load_params(path)), cfg
    from larynx_tpu_torch.convert.torch_import import (
        load_torch_state_dict,
        waveglow_params_from_state_dict,
    )

    return waveglow_params_from_state_dict(load_torch_state_dict(path, key="model"), cfg), cfg


class WaveGlowVocoder:
    """Vocoder: params (CPU tensors), config and sampling sigma, and, per
    (device, dtype) that a ``mels_to_audio`` call used, the packed params
    and the denoiser bias.

    ``half`` and ``denoiser_strength`` are the defaults of the model's own
    calls, as ``larynx_tpu.get_vocoder_model`` sets them."""

    def __init__(self, model_path: typing.Union[str, Path], backend=None, half: bool = False,
                 denoiser_strength: float = 0.0, sigma: typing.Optional[float] = None):
        tree, self.model_config = load_waveglow_artifacts(Path(model_path), backend)
        # the model dir's config records the sampling sigma
        self.sigma = self.model_config.sigma if sigma is None else sigma
        self.params = params_from_jax(tree, "waveglow")
        self.half = half
        self.denoiser_strength = denoiser_strength
        self.policy = BucketPolicy()
        # atomic under the GIL: concurrent calls never share a prior seed
        self._counter = itertools.count(1)
        self._packed = PerDevice(lambda device, dtype: wg_model.pack_params(
            cast(tree_to(self.params, device), dtype), self.model_config))
        self._bias = PerDevice(self._compute_bias_spec)

    def _generate(self, mels: torch.Tensor, z: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """mels [B, C, M] and the prior z [B, blocks, groups] -> float32 audio
        [B, M * upsample_stride]."""
        params = self._packed.get(mels.device, dtype)
        mel = mels.transpose(1, 2).contiguous().to(dtype)
        return wg_model.infer(params, self.model_config, mel, z=z.to(dtype)).float()

    def _prior(self, b: int, blocks: int, device) -> torch.Tensor:
        """sigma * N(0, 1) [b, blocks, groups], float32, from the next seed."""
        gen = torch.Generator(device=device)
        gen.manual_seed(next(self._counter))
        shape = (b, blocks, self.model_config.groups)
        return self.sigma * torch.randn(shape, generator=gen, device=device)

    def _halo_frames(self) -> int:
        """Mel frames covering the compound receptive field: each WN sees
        1 + (k-1)(2^layers - 1) blocks, the flows compose, and a mel frame
        conditions upsample_kernel / upsample_stride frames through the
        transposed conv.  A chunk padded by this halo reproduces the
        unchunked samples in its interior."""
        cfg = self.model_config
        rf_wn = 1 + (cfg.wn_kernel_size - 1) * (2**cfg.wn_layers - 1)
        blocks = cfg.flows * (rf_wn - 1)
        blocks_per_frame = cfg.upsample_stride // cfg.groups
        return -(-blocks // blocks_per_frame) + -(-cfg.upsample_kernel // cfg.upsample_stride)

    @torch.inference_mode()
    def mels_to_audio(self, mels: np.ndarray, settings=None, device=None) -> np.ndarray:
        """Post-processed mels [1, n_mels, M] -> int16 audio, on ``device``
        (None: CUDA).

        Beyond ``max(256, (MAX_VOCODE_AREA // 4) // rows)`` frames the mel is
        vocoded in receptive-field-haloed time chunks over one prior draw,
        so the WN activations stay bounded and the interior samples are the
        unchunked call's."""
        from larynx_tpu_torch.runtime import engine

        device = resolve_device(device)
        mels = np.asarray(mels, dtype=np.float32)
        if mels.ndim == 2:
            mels = mels[None]
        dtype = vocoder_dtype(self.half, device)
        cap = max(256, (engine.MAX_VOCODE_AREA // 4) // mels.shape[0])
        if mels.shape[-1] <= cap:
            audio = self._vocode_bucketed(mels, device, dtype)
        else:
            audio = self._vocode_chunked(mels, cap, device, dtype)

        strength = self.denoiser_strength
        if settings:
            strength = float(settings.get("denoiser_strength", strength))
        if strength > 0:
            audio = hifi_denoiser.denoise(audio, self.maybe_init_denoiser(device), strength)
        return audio_float_to_int16(audio.cpu().numpy().squeeze(0))

    def _vocode_bucketed(self, mels: np.ndarray, device, dtype) -> torch.Tensor:
        """The whole mel at its bucketed width, with a prior of that width."""
        cfg = self.model_config
        frames = mels.shape[-1]
        bucket = self.policy.mel_bucket(frames)
        mel = torch.from_numpy(pad_to_bucket(mels, bucket)).to(device)
        z = self._prior(mels.shape[0], bucket * cfg.upsample_stride // cfg.groups, device)
        return self._generate(mel, z, dtype)[:, : frames * cfg.upsample_stride]

    def _vocode_chunked(self, mels: np.ndarray, cap: int, device, dtype,
                        z_full: typing.Optional[torch.Tensor] = None) -> torch.Tensor:
        """Chunks of ``cap`` frames, each vocoded over ``halo`` more frames on
        both sides at its bucketed width, from slices of ONE utterance-wide
        prior draw (or ``z_full``), so both sides of a seam see the same
        noise."""
        cfg = self.model_config
        frames = mels.shape[-1]
        stride = cfg.upsample_stride
        halo = self._halo_frames()
        blocks_per_frame = stride // cfg.groups
        plan = []
        for start in range(0, frames, cap):
            lo, hi = max(0, start - halo), min(frames, start + cap + halo)
            plan.append((start, lo, hi, self.policy.mel_bucket(hi - lo)))
        if z_full is None:
            max_end = max(lo + bucket for _start, lo, _hi, bucket in plan)
            z_full = self._prior(mels.shape[0], max_end * blocks_per_frame, device)
        chunks = []
        for start, lo, hi, bucket in plan:
            mel_c = torch.from_numpy(pad_to_bucket(mels[:, :, lo:hi], bucket)).to(device)
            z_c = z_full[:, lo * blocks_per_frame : (lo + bucket) * blocks_per_frame]
            part = self._generate(mel_c, z_c, dtype)
            end = min(frames, start + cap)
            chunks.append(part[:, (start - lo) * stride : (end - lo) * stride])
        return torch.cat(chunks, dim=-1)

    def maybe_init_denoiser(self, device=None) -> torch.Tensor:
        """The bias spectrum on ``device`` in the call's vocoder dtype: a zero
        mel of 88 frames through a zero prior (sigma 0, NVIDIA's Denoiser
        mode), first STFT frame's magnitude; built once."""
        device = resolve_device(device)
        return self._bias.get(device, vocoder_dtype(self.half, device))

    @torch.inference_mode()
    def _compute_bias_spec(self, device, dtype) -> torch.Tensor:
        cfg = self.model_config
        frames = hifi_denoiser.BIAS_MEL_FRAMES
        zeros_mel = torch.zeros((1, cfg.mel_channels, frames), device=device)
        zeros_z = torch.zeros((1, frames * cfg.upsample_stride // cfg.groups, cfg.groups),
                              device=device)
        return hifi_denoiser.compute_bias_spec(self._generate(zeros_mel, zeros_z, dtype))
