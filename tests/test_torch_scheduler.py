"""The port's cross-request batch scheduler, on CPU, beside the JAX package's.

Counterparts of ``tests/test_scheduler.py`` on the port's engine (the small
GlowTTS voice and ResBlock1 HiFi-GAN of ``tests/test_torch_pipeline.py``),
the scheduler's audio against ``larynx_tpu``'s at ``noise_scale`` 0, and the
per-row noise that lets seeded requests share a batch.

Tolerances on int16 audio:
  * a seeded row in a batch against the same request alone, and the port
    against JAX: 2 LSB.  Batchmates change the padded text bucket and the
    vocoder group's width, which moves float32 conv sums by an ulp; both
    sides peak-normalise and truncate, so a sample moves at most twice.
  * the same seeded set resubmitted in another order: bit for bit.
  * per-row noise: bit for bit (it is drawn, not computed).
"""

import threading

import numpy as np
import pytest
import torch

import larynx_tpu
from larynx_tpu.runtime.scheduler import BatchScheduler as JBatchScheduler

import larynx_tpu_torch
from larynx_tpu_torch.runtime.scheduler import BatchScheduler

from test_torch_pipeline import TEXT, VOCODER, VOICE, voices_dir  # noqa: F401

LSB = 2


def _engine(module, voices_dir, **device):  # noqa: F811
    tts = module.get_tts_model(VOICE, custom_voices_dir=voices_dir, no_download=True)
    voc = module.get_vocoder_model(VOCODER, custom_voices_dir=voices_dir, no_download=True)
    return module._get_engine(tts, voc, **device)


@pytest.fixture(scope="module")
def engine(voices_dir):  # noqa: F811
    return _engine(larynx_tpu_torch, voices_dir, device=torch.device("cpu"))


def _lsb(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def _submit_all(scheduler, engine, seqs, seeds=None, order=None):
    """Submit every sequence from its own thread at once; results by index."""
    order = list(range(len(seqs))) if order is None else order
    barrier = threading.Barrier(len(order), timeout=60)
    futures, lock = {}, threading.Lock()

    def submit(i):
        barrier.wait()
        f = scheduler.submit(engine, seqs[i], seed=None if seeds is None else seeds[i])
        with lock:
            futures[i] = f

    threads = [threading.Thread(target=submit, args=(i,)) for i in order]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    return {i: futures[i].result(timeout=300) for i in order}


def test_concurrent_submits_coalesce(engine):
    scheduler = BatchScheduler(max_batch=8, max_wait_ms=500.0)
    rng = np.random.default_rng(0)
    seqs = [rng.integers(1, 46, size=rng.integers(8, 14)).astype(np.int64) for _ in range(8)]
    audios = _submit_all(scheduler, engine, seqs)
    scheduler.shutdown()
    assert all(a.dtype == np.int16 and a.size > 0 for a in audios.values())
    assert scheduler.jobs_run == 8
    assert scheduler.batches_run <= 3


def test_seeded_requests_reproducible_across_history(engine):
    """A seeded request returns the same audio however many batches ran
    before it; two concurrent identical seeded requests share a batch and
    match each other exactly, and the singleton run within 2 LSB."""
    scheduler = BatchScheduler(max_batch=8, max_wait_ms=10.0)
    ids = np.arange(1, 14, dtype=np.int64)
    first = scheduler.submit(engine, ids, seed=42).result(timeout=300)
    for _ in range(3):
        scheduler.submit(engine, ids).result(timeout=300)
    again = scheduler.submit(engine, ids, seed=42).result(timeout=300)
    f_a, f_b = scheduler.submit(engine, ids, seed=42), scheduler.submit(engine, ids, seed=42)
    conc_a, conc_b = f_a.result(timeout=300), f_b.result(timeout=300)
    scheduler.shutdown()
    np.testing.assert_array_equal(first, again)
    np.testing.assert_array_equal(conc_a, conc_b)
    assert conc_a.shape == first.shape and _lsb(conc_a, first) <= LSB


def test_cross_bucket_coalesce(engine):
    """Sentences in different text buckets share one batch."""
    scheduler = BatchScheduler(max_batch=8, max_wait_ms=1000.0)
    rng = np.random.default_rng(5)
    f_short = scheduler.submit(engine, rng.integers(1, 46, size=6).astype(np.int64))
    f_long = scheduler.submit(engine, rng.integers(1, 46, size=60).astype(np.int64))
    a_short, a_long = f_short.result(timeout=300), f_long.result(timeout=300)
    scheduler.shutdown()
    assert scheduler.jobs_run == 2 and scheduler.batches_run == 1
    assert 0 < a_short.size < a_long.size


def test_scheduler_error_propagation(engine):
    """A malformed job's error reaches the future of every job in its group."""
    scheduler = BatchScheduler(max_batch=2, max_wait_ms=200.0)
    bad = scheduler.submit(engine, np.zeros((3, 3), dtype=np.int64))  # 2-D "sequence"
    good = scheduler.submit(engine, np.arange(1, 10, dtype=np.int64))
    for future in (bad, good):
        with pytest.raises(Exception):
            future.result(timeout=120)
    scheduler.shutdown()
    assert scheduler.jobs_run == 0


def test_mixed_settings_coalesce(engine):
    """Jobs differing only in noise/length knobs share a batch, and per-row
    length_scale stretches only its own row."""
    scheduler = BatchScheduler(max_batch=8, max_wait_ms=1000.0)
    ids = np.arange(1, 13, dtype=np.int64)
    f_short = scheduler.submit(engine, ids, length_scale=1.0, noise_scale=0.2)
    f_long = scheduler.submit(engine, ids, length_scale=3.0, noise_scale=0.9)
    a_short, a_long = f_short.result(timeout=300), f_long.result(timeout=300)
    scheduler.shutdown()
    assert scheduler.jobs_run == 2 and scheduler.batches_run == 1
    ratio = a_long.size / max(a_short.size, 1)
    assert 2.0 < ratio < 4.5, ratio


def test_seeded_requests_coalesce_and_reproduce(engine):
    """Eight seeded requests share a batch, reproduce bit for bit in another
    arrival order, and each is within 2 LSB of the same request alone."""
    rng = np.random.default_rng(7)
    seqs = [rng.integers(1, 46, size=int(n)).astype(np.int64) for n in rng.integers(8, 15, size=8)]
    seeds = [100 + i for i in range(8)]
    runs = []
    for order in (list(range(8)), list(reversed(range(8)))):
        scheduler = BatchScheduler(max_batch=8, max_wait_ms=2000.0)
        runs.append(_submit_all(scheduler, engine, seqs, seeds, order))
        scheduler.shutdown()
        assert scheduler.batches_run <= 2, scheduler.batches_run
    for i in range(8):
        np.testing.assert_array_equal(runs[0][i], runs[1][i])
    solo_sched = BatchScheduler(max_batch=8, max_wait_ms=10.0)
    solo = solo_sched.submit(engine, seqs[3], seed=seeds[3]).result(timeout=300)
    solo_sched.shutdown()
    assert solo.shape == runs[0][3].shape and _lsb(solo, runs[0][3]) <= LSB


def test_scheduler_through_text_to_speech(voices_dir):  # noqa: F811
    """text_to_speech(scheduler=...) yields every sentence, in order, within
    2 LSB of the JAX package's scheduler path at noise_scale 0."""
    kwargs = dict(voice_or_lang=VOICE, vocoder_or_quality=VOCODER, custom_voices_dir=voices_dir,
                  tts_settings={"noise_scale": 0.0})
    scheduler, j_scheduler = BatchScheduler(max_batch=4, max_wait_ms=20.0), JBatchScheduler(4, 20.0)
    got = list(larynx_tpu_torch.text_to_speech(TEXT, scheduler=scheduler, device="cpu",
                                               no_download=True, **kwargs))
    want = list(larynx_tpu.text_to_speech(TEXT, scheduler=j_scheduler, **kwargs))
    scheduler.shutdown()
    j_scheduler.shutdown()
    assert [r.text for r in got] == [r.text for r in want] and len(got) == 2
    for g, w in zip(got, want):
        assert g.audio.dtype == np.int16 and g.audio.shape == w.audio.shape
        assert np.abs(w.audio.astype(np.int32)).max() > 1000
        assert _lsb(g.audio, w.audio) <= LSB
    assert scheduler.jobs_run == 2


def test_scheduler_audio_matches_jax(voices_dir, engine):  # noqa: F811
    """A coalesced ragged batch through both packages' schedulers at noise 0."""
    j_engine = _engine(larynx_tpu, voices_dir)
    rng = np.random.default_rng(3)
    seqs = [rng.integers(1, 46, size=n).astype(np.int64) for n in (9, 30, 14, 22)]
    scheduler, j_scheduler = BatchScheduler(8, 1000.0), JBatchScheduler(8, 1000.0)
    got = [scheduler.submit(engine, s, noise_scale=0.0) for s in seqs]
    want = [j_scheduler.submit(j_engine, s, noise_scale=0.0) for s in seqs]
    got, want = [f.result(timeout=300) for f in got], [f.result(timeout=300) for f in want]
    scheduler.shutdown()
    j_scheduler.shutdown()
    assert scheduler.batches_run == j_scheduler.batches_run == 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and _lsb(g, w) <= LSB


@pytest.mark.parametrize(
    "case", ["bucket 256 vs 1024", "row 0 of 1 vs row 5 of 8", "unseeded rows vary by batch"])
def test_row_noise_prefix_invariant(engine, case):
    """A seeded row's noise over its first 256 frames is the same bits at
    any mel bucket and any row position; unseeded rows follow the batch."""
    c = engine.glow_cfg.mel_channels
    if case == "bucket 256 vs 1024":
        a = engine.row_noise([9], 1, 256, c, batch_index=0)[0]
        b = engine.row_noise([9], 1, 1024, c, batch_index=3)[0]
        assert torch.equal(a, b[:256]) and not torch.equal(b[256:512], b[:256])
    elif case == "row 0 of 1 vs row 5 of 8":
        a = engine.row_noise([9], 1, 256, c, batch_index=0)[0]
        seeds = [None, 1, 2, None, 4, 9, None, 7]
        b = engine.row_noise(seeds, 8, 512, c, batch_index=11)
        assert torch.equal(a, b[5, :256])
        assert not torch.equal(b[0], b[3]) and not torch.equal(b[5], b[7])
    else:
        a = engine.row_noise([None, None], 2, 256, c, batch_index=1)
        b = engine.row_noise([None, None], 2, 256, c, batch_index=2)
        assert torch.equal(a, engine.row_noise([None, None], 2, 256, c, batch_index=1))
        assert not torch.equal(a[0], b[0]) and not torch.equal(a[0], a[1])
