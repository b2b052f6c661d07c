# Copied from larynx_tpu/models/waveglow/config.py; only the package name in its imports differs.
"""WaveGlow model geometry.

The reference *declares* the WaveGlow vocoder (larynx/constants.py:31,
larynx/VOCODERS:4) and ships its config (local/waveglow/wn_256/config.json
— the NVIDIA 256-channel model) but has no inference code for it
(larynx/__init__.py:498-508 has no waveglow branch).  Here it is a fully
working third vocoder family.
"""

import json
import typing
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class WaveGlowConfig:
    mel_channels: int = 80
    sampling_rate: int = 22050
    flows: int = 12
    groups: int = 8
    early_every: int = 4
    early_size: int = 2
    wn_kernel_size: int = 3
    wn_channels: int = 256
    wn_layers: int = 8
    # NVIDIA upsampling: ConvTranspose1d(80, 80, 1024, stride=256)
    upsample_kernel: int = 1024
    upsample_stride: int = 256
    # prior scale to SAMPLE with at inference (training records its own;
    # NVIDIA recommends sampling somewhat below the training sigma)
    sigma: float = 0.9

    def channels_at_flow(self, k: int) -> int:
        """Audio channels entering flow k (early outputs peel channels)."""
        c = self.groups
        for i in range(1, k + 1):
            if i % self.early_every == 0:
                c -= self.early_size
        return c

    @property
    def n_remaining(self) -> int:
        """Channels left after the last flow (the z tail at inference)."""
        return self.channels_at_flow(self.flows - 1)


def waveglow_config_from_json(
    source: typing.Union[str, Path, dict]
) -> WaveGlowConfig:
    """Load the reference's waveglow config.json (field names match)."""
    if isinstance(source, (str, Path)):
        with open(source, "r", encoding="utf-8") as f:
            data = json.load(f)
    else:
        data = dict(source)
    known = {f for f in WaveGlowConfig.__dataclass_fields__}
    return WaveGlowConfig(**{k: v for k, v in data.items() if k in known})
