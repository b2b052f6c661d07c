"""GlowTTS acoustic model, PyTorch port (inference and training)."""

from larynx_tpu_torch.models.glow_tts.config import (  # noqa: F401
    GlowTTSConfig,
    config_from_voice_json,
)
from larynx_tpu_torch.models.glow_tts.model import (  # noqa: F401
    decode_reverse,
    encode,
    expand_and_decode,
)
