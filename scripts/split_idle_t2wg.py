#!/usr/bin/env python3
"""Where the card idles in the benchmark's ``t2wg_batch8`` cell: the cell's
set-up and traffic (``portbench/``), untraced windows with the host's time
in the decode's steps (keep masks' draw, stop reads, postnet, vocode) per
block, then one profiled 2 s window whose device gaps are matched with the
host ranges open over them.  Needs one CUDA device.

    python3 scripts/split_idle_t2wg.py [--seed N] [--seconds 6] [--windows 2]

Prints, per window, ``rtf`` (window wall / seconds of audio) and each host
step's count, median, 99th percentile and largest ms; then the traced
window's idle by gap size and its longest gaps, each with the host ranges
(the port's spans, these labels, ATen ops, CUDA runtime calls) that overlap
it most.
"""

import argparse
import bisect
import collections
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HOST = collections.defaultdict(list)  # label -> host seconds of each call


def labelled(label, fn):
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(label):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            HOST[label].append(time.perf_counter() - t0)
            return out
    return wrapper


def label_host_steps():
    """Wrap the host steps of a batch in labelled, timed ranges."""
    from larynx_tpu_torch.models.tacotron2 import model as t2_model
    from larynx_tpu_torch.runtime.engine import SynthesisEngine
    from larynx_tpu_torch.runtime.tacotron2_engine import Tacotron2Engine

    t2_model.RowKeepMasks.__getitem__ = labelled("split.keep_draw",
                                                 t2_model.RowKeepMasks.__getitem__)
    t2_model.decode_steps = labelled("split.steps", t2_model.decode_steps)
    t2_model.postnet = labelled("split.postnet", t2_model.postnet)
    Tacotron2Engine._read_stops = labelled("split.read_stops", Tacotron2Engine._read_stops)
    for name in ("vocode_launch", "vocode_collect", "crop_rows"):
        raw = SynthesisEngine.__dict__[name]
        if isinstance(raw, staticmethod):
            setattr(SynthesisEngine, name, staticmethod(labelled(f"split.{name}", raw.__func__)))
        else:
            setattr(SynthesisEngine, name, labelled(f"split.{name}", raw))


def gaps_report(events, top=12):
    """Print the idle by gap size and the longest gaps with the host ranges
    that overlap them."""
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("ph") == "X"
                 and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    merged = []
    for a, b in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    window = merged[-1][1] - merged[0][0]
    gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]
    host = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in (
        "user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")), key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]

    def overlap(g0, g1):
        tally = collections.Counter()
        for e in host[bisect.bisect_left(starts, g0 - 2e5):]:
            if e["ts"] > g1:
                break
            o = min(g1, e["ts"] + e["dur"]) - max(g0, e["ts"])
            if o > 0:
                tally[f"{e['cat'][:4]}:{e['name'][:40]}"] += o
        return tally

    sizes = collections.Counter()
    for length, _g0, _g1 in gaps:
        sizes["<0.05ms" if length < 50 else "<0.5ms" if length < 500 else "<2ms"
              if length < 2000 else ">=2ms"] += length
    print(f"  window {window / 1e3:.1f} ms, busy {busy / 1e3:.1f} ms, idle "
          f"{(window - busy) / 1e3:.1f} ms; idle by gap size (ms): "
          f"{ {k: round(v / 1e3, 1) for k, v in sorted(sizes.items())} }")
    for length, g0, g1 in sorted(gaps, reverse=True)[:top]:
        print(f"  gap {length / 1e3:.2f} ms: " + "; ".join(
            f"{k} {v / 1e3:.2f}" for k, v in overlap(g0, g1).most_common(7)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1879048231)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--windows", type=int, default=2)
    args = ap.parse_args()

    from portbench import entries
    from portbench.harness.cell import Setup
    from portbench.run import load_cell
    from larynx_tpu_torch.runtime import trace

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    _cell, config, mix, _limits, _per_layer, _e2e = load_cell(bench, "t2wg_batch8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    label_host_steps()
    entry = entries.load(mix["entry"])
    t0 = time.perf_counter()
    s = Setup(config, mix, args.seed, torch.device("cuda", 0))
    entry.warm(s, 3.0)
    print(f"{torch.cuda.get_device_name()}; set-up {time.perf_counter() - t0:.1f} s", flush=True)
    rate = s.config["audio"]["sample_rate"]
    for w in range(args.windows):
        HOST.clear()
        torch.cuda.synchronize()
        out = entry.window(s, args.seconds)
        torch.cuda.synchronize()
        audio = sum(len(a) for call in out["outs"] for a in call) / rate
        stats = {k: (len(x), round(1e3 * float(np.median(x)), 3),
                     round(1e3 * float(np.percentile(x, 99)), 3), round(1e3 * max(x), 3))
                 for k, x in HOST.items()}
        print(f"window {w}: rtf {out['wall'] / audio:.7f} ({len(out['calls'])} calls); host "
              f"(n, median, p99, max ms): {stats}", flush=True)
    trace.enable(True)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        entry.window(s, 2.0, mark=torch.profiler.record_function)
        torch.cuda.synchronize()
    trace.enable(False)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    print("traced 2 s window:")
    gaps_report(events)
    return 0


if __name__ == "__main__":
    sys.exit(main())
