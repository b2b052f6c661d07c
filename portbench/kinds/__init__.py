"""Model kinds, one module each, found by the ``kind`` that a configuration
file names for its acoustic model and its vocoder: ``kinds/<kind>.py``.

A kind module holds what the benchmark knows of one model: its random
weights (``weights``), its FLOPs per request (``flops``), the port's config
class that builds it (``PORT_CONFIG``, a dotted path, so that nothing here
imports the port) and the plain reference's calls for it.  A configuration
with a new kind brings a new module and edits none.
"""

import importlib
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(kind):
    """The module of ``kind``; raises on a kind that has none."""
    if not re.fullmatch(r"[A-Za-z0-9_]+", str(kind)) or not (HERE / f"{kind}.py").is_file():
        raise ValueError(f"no model kind {kind!r}: portbench/kinds/{kind}.py does not exist")
    return importlib.import_module(f"portbench.kinds.{kind}")
