"""The comparison that decides ``correct``: a sample of the window's
requests, drawn from the seed with the longest among them, is synthesized
again by the plain reference, and each is held to the cell's limits.  The
entry (``entries/<entry>.py``) says what a request is and how it is
replayed; this module holds what every entry shares.

Numbers compared (``limits/<workload>.json`` holds each one's limit):

- ``length_mismatch``: requests whose sample count differs from the
  reference's.  Exact: the limit is 0.  A row with a duration within
  float32's reach of an integer may take the other ceiling; such rows are
  counted apart (``ambiguous``) and not compared.
- ``audio_err``: the worst request's ||program - reference|| / ||reference||
  over its int16 samples.
- ``failed``: requests that raised or never returned.  The limit is 0.
"""

import numpy as np


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1.0))


def pick(rng, n_items, k, longest):
    """k distinct indices of n_items drawn by ``rng``, ``longest`` among them."""
    others = [i for i in range(n_items) if i != longest]
    chosen = list(rng.choice(others, size=min(k - 1, len(others)), replace=False)) if others else []
    return sorted({int(longest), *map(int, chosen)})


class Tally:
    def __init__(self):
        self.compared = 0
        self.ambiguous = 0
        self.length_mismatch = 0
        self.audio_err = 0.0

    def row(self, got, want):
        self.compared += 1
        if len(got) != len(want):
            self.length_mismatch += 1
            return
        if len(want):
            self.audio_err = max(self.audio_err, rel_err(got, want))

    def numbers(self):
        return {"length_mismatch": self.length_mismatch, "audio_err": self.audio_err}
