"""The ``ar_batch`` entry: the ``batch`` entry's closed loop of
``SynthesisEngine.synthesize_batch`` calls for an autoregressive acoustic
model (its kind's ``AUTOREGRESSIVE``), each row given a step cap of the
mix's ``frames_per_id`` x its ids, rounded half up.  With the gate held off
(``kinds/nvidia_tacotron2.py``) every row ends at its cap, so the mix sets
the seconds of audio per id as the GlowTTS cells' calibration does.

``rtf`` and the per-layer readers' context are the ``batch`` entry's.
``correct``: ``limits["sample"]`` calls of the window, drawn from the seed
with the call that holds the longest row among them, are synthesized again:
each row alone through the plain reference (``reference/tacotron2.py``, in
float64) at the engine's mask and cap rules (``reference/ar_rules.py``),
then the call's vocode at the engine's rules (the mel bucket of its longest
row, ``rules.group_plan``, the vocoder kind's seeded prior, float32 with TF32
off, ``rules.to_int16``).  The controls: the vocoder kind's (``all`` also
puts the acoustic model in float32 with TF32 on) and ``acoustic``, the
acoustic model's products in TF32 with the vocoder's in bfloat16, as the
program's are.

For an acoustic kind that is not autoregressive every function is the
``batch`` entry's: the benchmark's CPU tests run every cell's mix on their
tiny GlowTTS configurations.
"""

import math
import time

import numpy as np
import torch

from portbench.entries import batch
from portbench.harness import check
from portbench.reference import ar_rules, rules
from portbench.reference import tacotron2 as reference
from portbench.reference.synth import _cast, _fp8, _tf32

end_to_end = batch.end_to_end
context = batch.context


def _bf16(x):
    """x rounded to bfloat16 (the program's vocoder products)."""
    return x.to(torch.bfloat16).to(x.dtype)


def _autoregressive(s):
    return getattr(s.acoustic, "AUTOREGRESSIVE", False)


def caps(mix, ids):
    """Each row's step cap: ``frames_per_id`` x its ids, rounded half up."""
    return [int(math.floor(mix["frames_per_id"] * len(x) + 0.5)) for x in ids]


def _loop(engine, batches, mix, seconds, mark=batch._nomark):
    calls, outs = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        ids = next(batches)
        with mark("batch"):
            audio = engine.synthesize_batch(ids, max_decoder_steps=caps(mix, ids))
        calls.append(ids)
        outs.append(audio)
    return {"calls": calls, "outs": outs, "wall": time.perf_counter() - t0}


def warm(s, seconds):
    """Each shape the traffic meets once, then ``seconds`` of the cell's own
    traffic from draws of its own.  Nothing carries over from one call to
    the next, so the reference replays none of them."""
    if not _autoregressive(s):
        return batch.warm(s, seconds)
    for ids in s.traffic.warmup_batches():
        s.engine.synthesize_batch(ids, max_decoder_steps=caps(s.mix, ids))
    _loop(s.engine, s.other_traffic().batches(), s.mix, seconds)
    s.batches = s.traffic.batches()
    return []


def window(s, seconds, mark=batch._nomark):
    if not _autoregressive(s):
        return batch.window(s, seconds, mark)
    return _loop(s.engine, s.batches, s.mix, seconds, mark)


class Reference:
    """A call's rows through the plain reference, or through a control
    (``scope``: the vocoder kind's controls or ``acoustic``)."""

    def __init__(self, s, scope=None):
        self.cfg, self.voc_cfg, self.audio = s.config["acoustic"], s.config["vocoder"], \
            s.config["audio"]
        self.vocoder, self.mix, self.device, self.seed = s.vocoder, s.mix, s.device, s.engine_seed
        self.buckets = rules.Buckets(s.mix["buckets"], self.cfg["n_sqz"])
        self.tf32 = scope in ("all", "acoustic")
        self.params = _cast(s.glow, torch.float32 if self.tf32 else torch.float64)
        self.voc = _cast(s.voc, torch.float32)
        self.q = {None: None, "acoustic": _bf16}.get(scope, _fp8)
        self.scope = "wn" if scope == "wn" else "all"

    @torch.no_grad()
    def row(self, ids, cap):
        """A row alone -> (mel [C, cap] float32, length)."""
        keep = None
        if self.cfg["p_prenet_dropout"] > 0.0:
            keep = ar_rules.keep_masks(self.cfg, self.seed, cap).to(self.device)
        ids = torch.as_tensor(np.asarray(ids, dtype=np.int64), device=self.device)
        with _tf32(self.tf32):
            mel, length = reference.infer(self.params, self.cfg, ids, keep, cap)
        return mel.float().T, length

    @torch.no_grad()
    def call(self, ids):
        """A synthesize_batch call's rows -> [int16 array] per row."""
        n = len(ids)
        rows = [self.row(x, ar_rules.step_cap(self.cfg, len(x), c))
                for x, c in zip(ids, caps(self.mix, ids))]
        y_len = np.array([length for _mel, length in rows], dtype=np.int64)
        m = self.buckets.mel_bucket(int(y_len.max()))
        mel = torch.stack([torch.nn.functional.pad(x[:, :m], (0, m - min(x.shape[1], m)))
                           for x, _length in rows])
        mel_pp = rules.postprocess(mel, y_len, self.audio)
        b_bucket = self.buckets.batch_bucket(n)
        valid = torch.zeros(b_bucket, dtype=torch.int64, device=self.device)
        valid[:n] = torch.as_tensor(y_len, device=self.device)
        prior = self.vocoder.prior(self.seed, 0, b_bucket, m, valid, self.voc_cfg, self.device)
        up = self.vocoder.upsample(self.voc_cfg)
        order = rules.sort_desc(y_len)
        out = [None] * n
        for start, size, width in rules.group_plan(self.buckets, y_len[order], m,
                                                   self.vocoder.AREA, up):
            idx = order[start : start + size]
            with _tf32(False):
                audio = self.vocoder.vocode(self.voc, self.voc_cfg, mel_pp[idx, :, :width], prior,
                                            idx, width, q=self.q, scope=self.scope)
            n_valid = torch.as_tensor(y_len[idx] * up, device=self.device)
            pcm = rules.to_int16(audio, n_valid).cpu().numpy()
            for j, r in enumerate(idx):
                out[r] = pcm[j, : y_len[r] * up]
        return out


def _held(tally, got_calls, want_calls):
    for got, want in zip(got_calls, want_calls):
        for g, w in zip(got, want):
            tally.row(g, w)
    return tally


def compare(s, out, warm_calls, limits):
    """The program's sampled calls against the reference -> Tally."""
    if not _autoregressive(s):
        return batch.compare(s, out, warm_calls, limits)
    calls = out["calls"]
    longest = int(np.argmax([max(len(a) for a in audio) for audio in out["outs"]]))
    picked = check.pick(s.check_rng(), len(calls), int(limits["sample"]), longest)
    ref = Reference(s)
    return _held(check.Tally(), [out["outs"][k] for k in picked],
                 [ref.call(calls[k]) for k in picked])


def control(s, scope, limits, n_calls):
    """The control in the program's place on the calls that a run would
    make, the same sample -> Tally."""
    if not _autoregressive(s):
        return batch.control(s, scope, limits, n_calls)
    if scope not in (*s.vocoder.CONTROLS, "acoustic"):
        raise ValueError(f"no control {scope!r} for this cell")
    batches = s.traffic.batches()
    calls = [next(batches) for _ in range(n_calls)]
    picked = batch._sample(s, calls, int(limits["sample"]))
    ctl, ref = Reference(s, scope), Reference(s)
    return _held(check.Tally(), [ctl.call(calls[k]) for k in picked],
                 [ref.call(calls[k]) for k in picked])
