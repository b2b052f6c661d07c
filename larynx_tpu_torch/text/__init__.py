# Copied from larynx_tpu/text/__init__.py; only the package name in its imports differs.
"""Text frontend: tokenization, normalization, SSML, phonemization, ids."""

from larynx_tpu_torch.text.ids import load_phoneme_ids, phonemes_to_ids  # noqa: F401
