# Copied from larynx_tpu/models/tacotron2/config.py; unchanged.
"""Tacotron2 model geometry.

The reference *declares* the Tacotron2 acoustic-model family
(larynx/constants.py:22 ``TextToSpeechType.TACOTRON2``) but ships no
inference code, config, or checkpoints for it (larynx/__init__.py:379-407
has no tacotron2 branch).  Here it is a fully working second acoustic
family: field names and defaults follow the NVIDIA/tacotron2 hparams the
enum refers to, so published NVIDIA checkpoints import directly
(convert/torch_import.py::tacotron2_params_from_state_dict).
"""

import typing
from dataclasses import dataclass


@dataclass(frozen=True)
class Tacotron2Config:
    num_symbols: int = 148
    mel_channels: int = 80
    n_frames_per_step: int = 1  # only 1 is supported (as in NVIDIA's repo)

    # encoder: 3 x (conv k5 C512 + batchnorm + relu) -> BiLSTM(256 each way)
    symbols_embedding_dim: int = 512
    encoder_kernel_size: int = 5
    encoder_n_convolutions: int = 3
    encoder_embedding_dim: int = 512

    # decoder
    prenet_dim: int = 256
    attention_rnn_dim: int = 1024
    decoder_rnn_dim: int = 1024
    max_decoder_steps: int = 1000
    gate_threshold: float = 0.5
    # NVIDIA quirk kept on purpose: prenet dropout stays ACTIVE at
    # inference (it is the model's only source of output variation)
    p_prenet_dropout: float = 0.5
    p_attention_dropout: float = 0.1  # training-only
    p_decoder_dropout: float = 0.1  # training-only

    # location-sensitive attention
    attention_dim: int = 128
    attention_location_n_filters: int = 32
    attention_location_kernel_size: int = 31

    # postnet: 5 x (conv k5 C512 + batchnorm), tanh except the last
    postnet_embedding_dim: int = 512
    postnet_kernel_size: int = 5
    postnet_n_convolutions: int = 5

    @property
    def encoder_lstm_dim(self) -> int:
        """Per-direction hidden size of the encoder BiLSTM."""
        return self.encoder_embedding_dim // 2


def tacotron2_config_from_voice_json(config: typing.Mapping) -> Tacotron2Config:
    """Build a config from a parsed voice ``config.json`` (model section)."""
    model = dict(config.get("model", {}))
    audio = config.get("audio", {})
    known = {f for f in Tacotron2Config.__dataclass_fields__}
    kwargs = {k: v for k, v in model.items() if k in known}
    kwargs.setdefault("mel_channels", audio.get("mel_channels", 80))
    return Tacotron2Config(**kwargs)
