"""Audio file I/O."""

from larynx_tpu_torch.io.wavfile import read, write  # noqa: F401
