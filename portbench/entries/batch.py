"""The ``batch`` entry: a closed loop of ``SynthesisEngine.synthesize_batch``
calls, each a batch of the mix's sentences, for a fixed time.

The window stops calling at ``seconds`` and ends when the last call has
returned its int16 rows to the host.  ``rtf`` is the window's wall time
over the seconds of audio (valid samples / the sample rate) of every row it
sent.  ``correct``: ``limits["sample"]`` calls of the window, drawn from the
seed with the call that holds the longest row among them, are synthesized
again by the plain reference, which replays every call the engine made
(warm-up first) to follow its predicted decode bucket.
"""

import contextlib
import time

import numpy as np

from portbench.harness import check
from portbench.reference import rules


def _nomark(name):
    return contextlib.nullcontext()


def _call(engine, ids, mix):
    return engine.synthesize_batch(ids, noise_scale=mix["noise_scale"],
                                   length_scale=mix["length_scale"])


def _loop(engine, batches, mix, seconds, mark=_nomark):
    calls, outs = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        ids = next(batches)
        with mark("batch"):
            audio = _call(engine, ids, mix)
        calls.append(ids)
        outs.append(audio)
    return {"calls": calls, "outs": outs, "wall": time.perf_counter() - t0}


def warm(s, seconds):
    """Each shape the traffic meets once, then ``seconds`` of the cell's own
    traffic (from draws of its own), so that the window starts in the steady
    state -> the warm-up's calls (the reference replays them)."""
    calls = s.traffic.warmup_batches()
    for ids in calls:
        _call(s.engine, ids, s.mix)
    pre = s.other_traffic()
    calls += _loop(s.engine, pre.batches(), s.mix, seconds)["calls"]
    s.batches = s.traffic.batches()
    return calls


def window(s, seconds, mark=_nomark):
    return _loop(s.engine, s.batches, s.mix, seconds, mark)


def end_to_end(out, s):
    """-> (metrics, requests attempted, requests failed)."""
    samples = sum(len(a) for call in out["outs"] for a in call)
    n = sum(len(c) for c in out["calls"])
    return {"rtf": out["wall"] / (samples / s.config["audio"]["sample_rate"])}, n, 0


def context(out, s):
    """What the per-layer readers read of the window: (ids, valid frames) of
    every request, and the number of calls."""
    up = s.vocoder.upsample(s.config["vocoder"])
    return {"requests": [(len(i), len(a) // up) for call, audio in zip(out["calls"], out["outs"])
                         for i, a in zip(call, audio)],
            "n_batches": len(out["calls"])}


def check_calls(ref, calls, outs, mix):
    """``calls``: every synthesize_batch call the engine made, in order, as
    id lists; ``outs``: call index -> the int16 rows judged for it."""
    ls, ns = mix["length_scale"], mix["noise_scale"]
    predictor = rules.Predictor(ref.buckets)
    tally = check.Tally()
    for k, ids in enumerate(calls):
        enc = ref.encode(ids, ls)
        m = predictor.decode_bucket(max(len(s) for s in ids), int(enc.y_len.max()), ls)
        if k not in outs:
            continue
        near = [i for i in np.flatnonzero(enc.ambiguous)
                if ref.buckets.mel_bucket(int(enc.y_len[i]) - 2)
                != ref.buckets.mel_bucket(int(enc.y_len[i]) + 2)]
        if near:  # a flipped ceiling could change the batch's buckets
            tally.ambiguous += len(ids)
            continue
        want = ref.batch(enc, len(ids), m, ref.buckets.batch_bucket(len(ids)), ns)
        for r, (row, exp) in enumerate(zip(outs[k], want)):
            if enc.ambiguous[r]:
                tally.ambiguous += 1
                continue
            tally.row(row, exp)
    return tally


def _sample(s, calls, k):
    longest = int(np.argmax([max(len(x) for x in ids) for ids in calls]))
    return check.pick(s.check_rng(), len(calls), k, longest)


def compare(s, out, warm_calls, limits):
    """The program's sampled calls against the reference -> Tally."""
    calls = out["calls"]
    longest = int(np.argmax([max(len(a) for a in audio) for audio in out["outs"]]))
    picked = check.pick(s.check_rng(), len(calls), int(limits["sample"]), longest)
    offset = len(warm_calls)
    outs = {offset + i: out["outs"][i] for i in picked}
    return check_calls(s.reference(), warm_calls + calls, outs, s.mix)


def control(s, scope, limits, n_calls):
    """The control in the program's place, on the calls that a run would
    make (each warm-up shape, then ``n_calls`` window calls; the short warm
    window left out), the same sample -> Tally."""
    ctl = s.reference(control=scope)
    warm_calls = s.traffic.warmup_batches()
    batches = s.traffic.batches()
    calls = [next(batches) for _ in range(n_calls)]
    picked = _sample(s, calls, int(limits["sample"]))
    ls, ns = s.mix["length_scale"], s.mix["noise_scale"]
    predictor = rules.Predictor(ctl.buckets)
    outs = {}
    for k, ids in enumerate(warm_calls + calls):
        enc = ctl.encode(ids, ls)
        m = predictor.decode_bucket(max(len(x) for x in ids), int(enc.y_len.max()), ls)
        if k - len(warm_calls) in picked:
            outs[k] = ctl.batch(enc, len(ids), m, ctl.buckets.batch_bucket(len(ids)), ns)
    return check_calls(s.reference(), warm_calls + calls, outs, s.mix)
