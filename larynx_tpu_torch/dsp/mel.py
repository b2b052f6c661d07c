"""Mel post-processing on the device.

Counterpart of ``larynx_tpu/dsp/mel.py``: ``mel_postprocess``, the chain
that the pipeline applies between the acoustic model and the vocoder, and
``linear_from_mel``, Griffin-Lim's projection of a mel back to linear
magnitudes.
"""

import torch

from larynx_tpu_torch.audio import AudioSettings


def mel_postprocess(mels: torch.Tensor, settings: AudioSettings) -> torch.Tensor:
    """denormalize -> db_to_amp -> dynamic range compression, per config flags."""
    x = mels
    if settings.signal_norm:
        if settings.symmetric_norm:
            if settings.clip_norm:
                x = torch.clamp(x, -settings.max_norm, settings.max_norm)
            x = (
                (x + settings.max_norm)
                * -settings.min_level_db
                / (2 * settings.max_norm)
            ) + settings.min_level_db
        else:
            if settings.clip_norm:
                x = torch.clamp(x, 0, settings.max_norm)
            x = (x * -settings.min_level_db / settings.max_norm) + settings.min_level_db
        x = x + settings.ref_level_db

    if settings.convert_db_to_amp:
        x = torch.pow(10.0, x / settings.spec_gain)

    if settings.do_dynamic_range_compression:
        x = torch.log(torch.clamp(x, min=1e-5))

    return x


def dynamic_range_decompression(x: torch.Tensor, C: float = 1.0) -> torch.Tensor:
    return torch.exp(x) / C


def linear_from_mel(
    mels: torch.Tensor, mel_basis: torch.Tensor, mel_scaling: float = 1000.0
) -> torch.Tensor:
    """Mel [B, n_mels, T] -> linear magnitude [B, n_freq, T] through the
    transposed mel basis ([n_mels, n_freq]): dynamic-range decompress,
    project, scale (``larynx_tpu/dsp/mel.py::linear_from_mel``)."""
    amp = dynamic_range_decompression(mels.float())
    return torch.einsum("bmt,mf->bft", amp, mel_basis.float()) * mel_scaling
