"""Entries of the program that a window drives, one module each, found by
the ``entry`` that a traffic mix names: ``entries/<entry>.py``.

An entry module gives ``warm(s, seconds)``, ``window(s, seconds, mark)``,
``end_to_end(out, s)``, ``context(out, s)`` (what the per-layer readers
read), ``compare(s, out, warm_state, limits)`` and ``control(s, scope,
limits, n)``, where ``s`` is the run's :class:`portbench.harness.cell.Setup`.
A mix with a new entry brings a new module and edits none.
"""

import importlib
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(entry):
    """The module of ``entry``; raises on an entry that has none."""
    if not re.fullmatch(r"[A-Za-z0-9_]+", str(entry)) or not (HERE / f"{entry}.py").is_file():
        raise ValueError(f"no entry {entry!r}: portbench/entries/{entry}.py does not exist")
    return importlib.import_module(f"portbench.entries.{entry}")
