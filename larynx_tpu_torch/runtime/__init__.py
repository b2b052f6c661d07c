"""Synthesis runtime: bucketing and the batching engine."""

from larynx_tpu_torch.runtime.buckets import BucketPolicy  # noqa: F401
