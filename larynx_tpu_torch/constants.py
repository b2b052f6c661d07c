# Copied from larynx_tpu/constants.py; the package name in its imports and the
# InferenceBackend docstring differ.
"""Public enums, config dataclasses, and abstract model interfaces.

TPU-native re-design of the reference interfaces in
``larynx/constants.py:19-114`` (rhasspy/larynx).  The reference delegates
model math to ONNX Runtime sessions; here every model is a JAX program, so
the configs carry checkpoint paths + precision/backend hints instead of ORT
session options.
"""

import typing
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path

import numpy as np

# -----------------------------------------------------------------------------


class TextToSpeechType(str, Enum):
    """Available acoustic model families (parity: larynx/constants.py:19-23)."""

    TACOTRON2 = "tacotron2"  # declared-only in the reference; implemented here
    GLOW_TTS = "glow_tts"


class VocoderType(str, Enum):
    """Available vocoder families (parity: larynx/constants.py:26-31)."""

    GRIFFIN_LIM = "griffin_lim"
    HIFI_GAN = "hifi_gan"
    WAVEGLOW = "waveglow"  # declared-only in the reference; implemented here


class VocoderQuality(str, Enum):
    """Quality presets mapping to specific vocoders (larynx/constants.py:37-40)."""

    HIGH = "high"
    MEDIUM = "medium"
    LOW = "low"


class InferenceBackend(str, Enum):
    """Checkpoint format preference.

    In the port the models always run in PyTorch; this only selects which
    artifact in a voice directory is converted to the parameter tree
    (``.npz``, ``.pth`` or ``.onnx``; the reference used it to pick the
    runtime: larynx/constants.py:43-45).
    """

    ONNX = "onnx"
    PYTORCH = "pytorch"
    JAX = "jax"  # native orbax/msgpack checkpoints produced by this framework


# -----------------------------------------------------------------------------

SettingsType = typing.Dict[str, typing.Any]
ARRAY_OR_TENSOR = np.ndarray  # everything crossing the public API is numpy


@dataclass
class TextToSpeechModelConfig:
    """Configuration for loading an acoustic model.

    Parity with larynx/constants.py:51-59, minus ORT session options.
    """

    model_path: Path
    backend: typing.Optional[InferenceBackend] = None
    half: bool = False  # bfloat16 compute on TPU when True
    seed: typing.Optional[int] = None
    # Engine hints (TPU-specific, no reference equivalent):
    max_batch: int = 8
    length_buckets: typing.Optional[typing.Sequence[int]] = None


@dataclass
class VocoderModelConfig:
    """Configuration for loading a vocoder (parity: larynx/constants.py:78-87)."""

    model_path: Path
    backend: typing.Optional[InferenceBackend] = None
    half: bool = False
    denoiser_strength: float = 0.0
    max_batch: int = 8


# -----------------------------------------------------------------------------


class TextToSpeechModel(ABC):
    """Abstract acoustic model: phoneme ids -> mel spectrograms.

    Parity with larynx/constants.py:62-72.
    """

    def __init__(self, config: TextToSpeechModelConfig):
        self.config = config

    @abstractmethod
    def phonemes_to_mels(
        self,
        phoneme_ids: np.ndarray,
        settings: typing.Optional[SettingsType] = None,
    ) -> np.ndarray:
        """Convert phoneme ids [T] (or [B, T]) to mel spectrograms [B, n_mels, T']."""


class VocoderModel(ABC):
    """Abstract vocoder: mel spectrograms -> waveform.

    Parity with larynx/constants.py:90-100.
    """

    def __init__(self, config: VocoderModelConfig):
        self.config = config

    @abstractmethod
    def mels_to_audio(
        self,
        mels: np.ndarray,
        settings: typing.Optional[SettingsType] = None,
    ) -> np.ndarray:
        """Convert mel spectrograms [B, n_mels, T'] to int16 waveform samples."""


# -----------------------------------------------------------------------------


@dataclass
class TextToSpeechResult:
    """One synthesized sentence (parity: larynx/constants.py:106-114)."""

    text: str
    audio: typing.Optional[np.ndarray]
    sample_rate: int
    marks_before: typing.List[str] = field(default_factory=list)
    marks_after: typing.List[str] = field(default_factory=list)
