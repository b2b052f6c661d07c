"""Data-parallel synthesis over a serving mesh.

Counterpart of ``larynx_tpu/parallel/serve.py``: the whole pipeline (encode
-> expand and decode -> mel post-processing -> HiFi-GAN) as one step, the
batch rows split over the mesh's positions and the params replicated on
each device.  Each position's rows run on its device from this one thread.
"""

import math
import typing

import torch

import larynx_tpu_torch.dsp.mel as dspmel
from larynx_tpu_torch.device import to_device
from larynx_tpu_torch.models.glow_tts import model as glow_model
from larynx_tpu_torch.models.glow_tts.config import GlowTTSConfig
from larynx_tpu_torch.models.hifi_gan import model as hifi_model
from larynx_tpu_torch.models.hifi_gan.config import HiFiGanConfig
from larynx_tpu_torch.weights import tree_to


def make_sharded_synthesis(
    glow_cfg: GlowTTSConfig,
    vocoder_cfg: typing.Optional[HiFiGanConfig],
    mesh,
    mel_max_length: int,
    audio_settings=None,
):
    """``run(glow_params, voc_params, ids [B, T], lengths [B], seed,
    noise_scale=0.667)`` -> (audio [B, M * upsample] float32, or the mel [B,
    M, C] without a vocoder; y_lengths [B]), on the first position.

    Params are in the port's layout (the vocoder's unpacked; each device's
    replica is packed for the kernels); ids and lengths are numpy, B a
    multiple of the mesh's size.  The latent noise is drawn once for the
    batch on the first position from a generator seeded by ``seed``."""
    positions = mesh.positions
    n = len(positions)

    def run(glow_params, voc_params, ids, lengths, seed: int, noise_scale: float = 0.667):
        b = ids.shape[0]
        if b % n:
            raise ValueError(f"{b} rows do not split over {n} positions")
        s = b // n
        glow_of = {dev: tree_to(glow_params, dev) for dev in mesh.devices}
        voc_of = {}
        if voc_params is not None and vocoder_cfg is not None:
            voc_of = {dev: hifi_model.pack_params(tree_to(voc_params, dev), vocoder_cfg)
                      for dev in mesh.devices}
        gen = torch.Generator(device=positions[0]).manual_seed(seed)
        noise = torch.randn((b, mel_max_length, glow_cfg.mel_channels), generator=gen,
                            device=positions[0])
        outs, y_out = [], []
        for k, dev in enumerate(positions):
            rows = slice(k * s, (k + 1) * s)
            x_m, x_logs, _logw, w_ceil, y_lengths, _mask = glow_model.encode(
                glow_of[dev], glow_cfg, to_device(ids[rows], dev), to_device(lengths[rows], dev))
            # the mel bucket is fixed; y_lengths is clipped into it
            y_lengths = torch.clamp(y_lengths, max=mel_max_length)
            mel, z_mask = glow_model.expand_and_decode(
                glow_of[dev], glow_cfg, x_m, x_logs, w_ceil, y_lengths,
                mel_max_length=mel_max_length, noise_scale=noise_scale,
                noise=noise[rows].to(dev, non_blocking=True),
            )
            out = mel
            if voc_of:
                if audio_settings is not None:
                    mel_cm = dspmel.mel_postprocess(mel.transpose(1, 2), audio_settings)
                    mel = torch.where(z_mask[:, None, :] > 0, mel_cm,
                                      math.log(1e-5)).transpose(1, 2)
                out = hifi_model.generator(voc_of[dev], vocoder_cfg, mel)
            outs.append(out.to(positions[0], non_blocking=True))
            y_out.append(y_lengths.to(positions[0], non_blocking=True))
        return torch.cat(outs), torch.cat(y_out)

    return run
