# Copied from larynx_tpu/models/hifi_gan/config.py; only the package name in its imports differs.
"""HiFi-GAN generator hyperparameters.

Tracks the reference's ModelConfig/AudioConfig (hifi_gan/config.py:12-40).
Voice-dir configs come in two shapes: nested ``{"model": ..., "audio": ...}``
(vctk_medium/vctk_small) and the flat original-HiFi-GAN format
(universal_large) — :func:`hifi_gan_config_from_json` accepts both.
"""

import typing
from dataclasses import dataclass


@dataclass(frozen=True)
class HiFiGanConfig:
    resblock: str = "1"  # "1" = ResBlock1 (3 dilated+plain pairs), "2" = 2 dilated
    upsample_rates: typing.Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: typing.Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: typing.Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: typing.Tuple[typing.Tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )

    num_mels: int = 80
    sampling_rate: int = 22050
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024

    @property
    def total_upsample(self) -> int:
        out = 1
        for u in self.upsample_rates:
            out *= u
        return out

    @property
    def num_kernels(self) -> int:
        return len(self.resblock_kernel_sizes)


def hifi_gan_config_from_json(config: typing.Mapping) -> HiFiGanConfig:
    """Parse either the nested or the flat config.json shape."""
    if "model" in config or "audio" in config:
        model = dict(config.get("model", {}))
        audio = dict(config.get("audio", {}))
    else:
        model = dict(config)
        audio = dict(config)

    def tup(x):
        if x is None:
            return None
        return tuple(tuple(i) if isinstance(i, (list, tuple)) else i for i in x)

    kwargs: typing.Dict[str, typing.Any] = {}
    for k in (
        "resblock",
        "upsample_initial_channel",
    ):
        if k in model:
            kwargs[k] = model[k]
    for k in (
        "upsample_rates",
        "upsample_kernel_sizes",
        "resblock_kernel_sizes",
        "resblock_dilation_sizes",
    ):
        if model.get(k) is not None:
            kwargs[k] = tup(model[k])

    kwargs["num_mels"] = audio.get("num_mels", 80)
    kwargs["sampling_rate"] = audio.get(
        "sampling_rate", audio.get("sample_rate", 22050)
    )
    kwargs["n_fft"] = audio.get("n_fft", audio.get("filter_length", 1024))
    kwargs["hop_length"] = audio.get("hop_length", audio.get("hop_size", 256))
    kwargs["win_length"] = audio.get("win_length", audio.get("win_size", 1024))
    if "resblock" in kwargs:
        kwargs["resblock"] = str(kwargs["resblock"])
    return HiFiGanConfig(**kwargs)
