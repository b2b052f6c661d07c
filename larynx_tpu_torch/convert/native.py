# Copied from larynx_tpu/convert/native.py; only the package name in its imports differs.
"""Native checkpoint format: parameter pytrees <-> flat .npz archives.

Voice dirs may carry ``generator.npz`` alongside (or instead of) the
reference's ``generator.onnx`` / ``generator.pth``; loading an .npz skips
conversion entirely.  Keys encode the tree path ("a/b/0/c" — integer
segments rebuild lists).
"""

import typing
from pathlib import Path

import numpy as np


def _flatten(tree, prefix="") -> typing.Iterator[typing.Tuple[str, np.ndarray]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], np.asarray(tree)


def save_params(path: typing.Union[str, Path], params) -> None:
    flat = dict(_flatten(params))
    np.savez(str(path), **flat)


def load_params(path: typing.Union[str, Path]):
    archive = np.load(str(path))
    root: typing.Dict[str, typing.Any] = {}
    for key in archive.files:
        parts = key.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = archive[key]
    return _listify(root)


def _listify(node):
    """Convert dicts with contiguous integer keys back into lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        indices = sorted(int(k) for k in out)
        if indices == list(range(len(indices))):
            return [out[str(i)] for i in indices]
    return out
