"""WaveGlow vocoder, PyTorch port (inference and training)."""

from larynx_tpu_torch.models.waveglow.config import (  # noqa: F401
    WaveGlowConfig,
    waveglow_config_from_json,
)
