"""Training steps; the multi-GPU mesh of ``larynx_tpu/parallel`` is not
ported yet (ROADMAP)."""
