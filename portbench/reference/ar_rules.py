"""The rules of the serving engine's autoregressive path that decide a
Tacotron2 row's output, restated for the reference
(``larynx_tpu_torch/runtime/tacotron2_engine.py`` documents them; nothing
of the port is imported):

- prenet keep masks: every row of a call without seeds (the benchmark's
  calls) draws its masks from ``SeedSequence([S & 0xFFFFFFFF, 0])``, S the
  engine's seed, whatever its place in the batch: a ``torch.Generator`` on
  the CPU fills u [steps, 2, prenet_dim] uniform, and the row keeps
  u < 1 - p;
- step cap: the row's given ``max_decoder_steps``, at most 10 x its own
  text bucket;
- the vocoder's mel is as wide as the mel bucket of the batch's longest row
  (silence past each row's stop); its row groups and WaveGlow prior follow
  ``rules.py`` at that width.
"""

import numpy as np
import torch

TEXT_BUCKETS = (16, 32, 64, 96, 128, 192, 256, 384)  # the step budget's text buckets
FRAMES_PER_ID_BUDGET = 10


def keep_masks(cfg, seed, steps):
    """The keep masks [steps, 2, prenet_dim] (bool, CPU) of a row drawn at
    ``seed``."""
    state = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, 0]).generate_state(1)
    gen = torch.Generator().manual_seed(int(state[0]))
    u = torch.rand((steps, 2, cfg["prenet_dim"]), generator=gen)
    return u < 1.0 - cfg["p_prenet_dropout"]


def step_cap(cfg, n_ids, max_decoder_steps):
    """The steps a row of ``n_ids`` ids given ``max_decoder_steps`` may run."""
    bucket = next((b for b in TEXT_BUCKETS if b >= n_ids), n_ids)
    return max(1, min(int(max_decoder_steps), FRAMES_PER_ID_BUDGET * bucket))
