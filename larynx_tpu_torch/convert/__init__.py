"""Checkpoint formats the port reads: the native ``.npz`` archive, NVIDIA /
reference ``.pth`` state dicts (``torch_import``) and ``.onnx`` exports
(``onnx_import``), each converted to the JAX package's native tree, which
``weights.params_from_jax`` turns into the port's tensors."""

import json
import typing
from pathlib import Path

from larynx_tpu_torch.constants import InferenceBackend


def read_config(model_dir: Path) -> dict:
    """A voice or vocoder dir's parsed ``config.json``."""
    with open(model_dir / "config.json", "r", encoding="utf-8") as f:
        return json.load(f)


def resolve_checkpoint(
    model_dir: Path,
    backend: typing.Optional[InferenceBackend],
    candidates: typing.Dict[InferenceBackend, typing.List[Path]],
    missing: str,
) -> Path:
    """The file a family's loader converts, in the ``larynx_tpu`` loaders'
    order: a ``backend`` the family has a format for narrows the order to
    that format's files; no backend, or one it has none for, tries every
    format in the order of ``candidates``.  Nothing loadable raises
    ``FileNotFoundError(f"{missing} in {model_dir}")``."""
    if backend in candidates:
        order = candidates[backend]
    else:
        order = [path for paths in candidates.values() for path in paths]
    for path in order:
        if path.is_file():
            return path
    raise FileNotFoundError(f"{missing} in {model_dir}")
