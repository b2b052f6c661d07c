# Copied from larynx_tpu/models/glow_tts/config.py; only the package name in its imports differs.
"""GlowTTS model hyperparameters.

Field names/defaults track the per-voice ``config.json`` ``model`` section
(reference: glow_tts/config.py:35-61), e.g.
local/en-us/harvard-glow_tts/config.json.
"""

import typing
from dataclasses import dataclass


@dataclass(frozen=True)
class GlowTTSConfig:
    num_symbols: int = 46
    n_speakers: int = 1
    mel_channels: int = 80

    hidden_channels: int = 192
    filter_channels: int = 768
    filter_channels_dp: int = 256
    kernel_size: int = 3
    n_heads: int = 2
    n_layers_enc: int = 6
    window_size: typing.Optional[int] = 4
    block_length: typing.Optional[int] = None
    mean_only: bool = True
    prenet: bool = True

    n_blocks_dec: int = 12
    kernel_size_dec: int = 5
    dilation_rate: int = 1
    n_block_layers: int = 4
    n_split: int = 4
    n_sqz: int = 2
    sigmoid_scale: bool = False
    gin_channels: int = 0

    hidden_channels_enc: typing.Optional[int] = None
    hidden_channels_dec: typing.Optional[int] = None

    # dropout rates are training-only; kept for config parity
    p_dropout: float = 0.1
    p_dropout_dec: float = 0.05

    @property
    def enc_channels(self) -> int:
        return self.hidden_channels_enc or self.hidden_channels

    @property
    def dec_channels(self) -> int:
        return self.hidden_channels_dec or self.hidden_channels

    @property
    def k_channels(self) -> int:
        return self.enc_channels // self.n_heads

    @property
    def sqz_channels(self) -> int:
        """Flow channel count after time-squeeze."""
        return self.mel_channels * self.n_sqz


def config_from_voice_json(config: typing.Mapping) -> GlowTTSConfig:
    """Build a config from a parsed voice ``config.json``."""
    model = dict(config.get("model", {}))
    audio = config.get("audio", {})
    known = {f for f in GlowTTSConfig.__dataclass_fields__}
    kwargs = {k: v for k, v in model.items() if k in known}
    kwargs.setdefault("mel_channels", audio.get("mel_channels", 80))
    return GlowTTSConfig(**kwargs)
