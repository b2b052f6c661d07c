"""HiFi-GAN vocoder, PyTorch port (inference and training)."""

from larynx_tpu_torch.models.hifi_gan.config import (  # noqa: F401
    HiFiGanConfig,
    hifi_gan_config_from_json,
)
from larynx_tpu_torch.models.hifi_gan.model import generator  # noqa: F401
