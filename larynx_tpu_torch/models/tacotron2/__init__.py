"""Tacotron2 acoustic model, PyTorch port (inference and training)."""

from larynx_tpu_torch.models.tacotron2.config import (  # noqa: F401
    Tacotron2Config,
    tacotron2_config_from_voice_json,
)
from larynx_tpu_torch.models.tacotron2.model import (  # noqa: F401
    decode_blocked,
    draw_keep_masks,
    encode,
    infer,
    postnet,
)
