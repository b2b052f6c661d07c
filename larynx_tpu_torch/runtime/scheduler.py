# Copied from larynx_tpu/runtime/scheduler.py, driving the port's engine:
# only the package names, the logger and the launch comments differ,
# y_lengths is read through the copy that encode_launch started, the encode
# launch takes the rows' seeds and step caps (a Tacotron2 voice decodes
# inside it), and the queue waits and groups are traced (runtime/trace.py).
"""Request-coalescing batch scheduler.

Concurrent requests enqueue sentence-level jobs into a shared scheduler; a
worker thread drains the queue, groups compatible jobs (same engine and
denoiser on/off; noise, length and denoiser knobs are per row), and runs
each group as one batched engine call, so many concurrent requests become
a handful of batched device calls.  All device work runs on the worker
thread: the engine's launch methods enter ``torch.inference_mode``
themselves, which is per thread.

Traced as ``scheduler.queue`` (a job's wait from its submit to the worker
taking it, id the job's) and ``scheduler.group`` (a group's encode launch
to its audio set).
"""

import itertools
import logging
import queue
import threading
import time
import typing
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np

from larynx_tpu_torch.runtime import trace

_LOGGER = logging.getLogger("larynx_tpu_torch.scheduler")


@dataclass
class _Job:
    engine: typing.Any
    ids: np.ndarray
    noise_scale: float
    length_scale: float
    denoiser_strength: float
    seed: typing.Optional[int]
    max_decoder_steps: typing.Optional[int] = None  # an autoregressive voice's step cap
    id: int = 0
    submitted_ns: int = 0  # time.perf_counter_ns() at submit
    future: "Future[np.ndarray]" = field(default_factory=Future)

    def group_key(self):
        """noise/length/denoiser knobs are per-ROW in the engine, so jobs
        differing only in those still share a batch; so do jobs in
        different text buckets (encode pads to the batch max bucket, and
        the vocoder runs length-sorted ragged groups, so a short sentence
        riding in a long batch costs little).  The denoiser on/off flag
        must match.

        Explicitly-SEEDED jobs also batch when the vocoder is
        deterministic (HiFi-GAN): the engine draws each row's latent
        noise from its OWN seed (decode_launch row_seeds), so a seeded
        row's NOISE does not depend on its row index, the batch counter,
        or server history.  The audio is reproducible to within a couple
        int16 LSB rather than bit-exact: batchmates set the encode text
        bucket and the length-sorted ragged vocode group widths, and a
        different padded width shifts conv edge arithmetic by an ulp.
        Stochastic vocoders (the WaveGlow prior) still key their noise off
        the batch, so seeded jobs there keep singleton groups."""
        seeded_singleton = (
            self.seed is not None
            and getattr(self.engine, "vocoder_kind", "") != "hifi_gan"
        )
        return (
            id(self.engine),
            id(self) if seeded_singleton else None,
            self.denoiser_strength > 0,
        )


class BatchScheduler:
    """Shared sentence-batching frontend for one or more engines."""

    def __init__(self, max_batch: int = 8, max_wait_ms: float = 15.0):
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self._queue: "queue.Queue[typing.Optional[_Job]]" = queue.Queue()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._started = False
        self._lock = threading.Lock()
        self._batch_counter = 0
        self._job_ids = itertools.count()
        self.batches_run = 0
        self.jobs_run = 0

    def _ensure_started(self):
        if not self._started:
            with self._lock:
                if not self._started:
                    self._thread.start()
                    self._started = True

    def submit(
        self,
        engine,
        ids: np.ndarray,
        noise_scale: float = 0.667,
        length_scale: float = 1.0,
        denoiser_strength: float = 0.0,
        seed: typing.Optional[int] = None,
        max_decoder_steps: typing.Optional[int] = None,
    ) -> "Future[np.ndarray]":
        """Queue one sentence; the future resolves to int16 audio."""
        self._ensure_started()
        job = _Job(engine, np.asarray(ids), noise_scale, length_scale,
                   denoiser_strength, seed, max_decoder_steps, id=next(self._job_ids),
                   submitted_ns=time.perf_counter_ns())
        self._queue.put(job)
        return job.future

    def shutdown(self):
        if self._started:
            self._queue.put(None)

    # ------------------------------------------------------------------

    def _collect(self) -> typing.List[_Job]:
        """Block for one job, then drain compatible peers until the batch
        window closes or max_batch is hit."""
        first = self._queue.get()
        if first is None:
            raise StopIteration
        trace.record("scheduler.queue", first.submitted_ns, id=first.id)
        jobs = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(jobs) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                job = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if job is None:
                self._queue.put(None)  # re-signal shutdown
                break
            trace.record("scheduler.queue", job.submitted_ns, id=job.id)
            jobs.append(job)
        return jobs

    def _worker(self):
        while True:
            try:
                jobs = self._collect()
            except StopIteration:
                return

            groups: typing.Dict[typing.Any, typing.List[_Job]] = {}
            for job in jobs:
                groups.setdefault(job.group_key(), []).append(job)

            # every group's encode is launched first; group j+1's decode +
            # vocode is launched before group j's audio is collected, so the
            # device works on the next group while the host copies this one
            ordered = list(groups.values())
            started = []
            launched = []
            for g in ordered:
                started.append(time.perf_counter_ns())
                launched.append(self._launch_encode(g))
            tails: typing.List[typing.Any] = [None] * len(ordered)
            if ordered:
                tails[0] = self._launch_tail(ordered[0], launched[0])
            for j, group in enumerate(ordered):
                if j + 1 < len(ordered):
                    tails[j + 1] = self._launch_tail(
                        ordered[j + 1], launched[j + 1]
                    )
                self._collect_group(group, tails[j])
                trace.record("scheduler.group", started[j], rows=len(group),
                             jobs=[job.id for job in group])

    def _launch_encode(self, group: typing.List[_Job]):
        engine = group[0].engine
        try:
            return engine.encode_launch(
                [job.ids for job in group],
                length_scale=[job.length_scale for job in group],
                seed=[job.seed for job in group],
                max_decoder_steps=[job.max_decoder_steps for job in group],
            )
        except Exception as err:
            return err

    def _launch_tail(self, group: typing.List[_Job], enc):
        if isinstance(enc, Exception):
            return enc
        engine = group[0].engine
        self._batch_counter += 1
        try:
            enc_out, g = enc
            y_lengths = engine.host_lengths(enc_out, len(group))
            strengths = [job.denoiser_strength for job in group]
            deterministic_vocoder = (
                getattr(engine, "vocoder_kind", "") == "hifi_gan"
            )
            if (
                group[0].seed is not None and not deterministic_vocoder
            ):
                # stochastic vocoder (the WaveGlow prior) keys its noise off
                # the batch: the singleton seeded group reproduces through
                # the scalar path at batch_index 0
                parts, b_rows = engine.synthesize_launch(
                    enc_out, y_lengths, g, len(group),
                    noise_scale=[job.noise_scale for job in group],
                    seed=group[0].seed,
                    batch_index=0,
                    denoiser_strength=strengths,
                )
            elif any(job.seed is not None for job in group):
                # per-row noise: each seeded row reproduces from its own
                # seed regardless of batchmates or server history;
                # unseeded rows vary by the batch counter as usual
                parts, b_rows = engine.synthesize_launch(
                    enc_out, y_lengths, g, len(group),
                    noise_scale=[job.noise_scale for job in group],
                    batch_index=self._batch_counter,
                    denoiser_strength=strengths,
                    row_seeds=[job.seed for job in group],
                )
            else:
                parts, b_rows = engine.synthesize_launch(
                    enc_out, y_lengths, g, len(group),
                    noise_scale=[job.noise_scale for job in group],
                    seed=None,
                    batch_index=self._batch_counter,
                    denoiser_strength=strengths,
                )
            return (parts, y_lengths, b_rows, strengths)
        except Exception as err:
            return err

    def _collect_group(self, group: typing.List[_Job], tail):
        engine = group[0].engine
        try:
            if isinstance(tail, Exception):
                raise tail
            parts, y_lengths, b_rows, strengths = tail
            audio_rows = engine.vocode_collect(parts, b_rows)
            audios = engine.crop_rows(
                audio_rows, y_lengths, len(group), strengths
            )
            self.batches_run += 1
            self.jobs_run += len(group)
            _LOGGER.debug(
                "Batched %s sentence(s) into one call (total batches=%s)",
                len(group),
                self.batches_run,
            )
            for job, audio in zip(group, audios):
                job.future.set_result(audio)
        except Exception as err:  # propagate to every caller of the group
            for job in group:
                if not job.future.done():
                    job.future.set_exception(err)
