"""The flow decode's bound (PERF.md's kernel table, on the H100's published
peaks) and the two readers of the flow decode: ``flow_roofline`` and
``flow_wn_pct.batch``."""

import json
import types
from pathlib import Path

import pytest

from portbench.counts import peaks
from portbench.kinds import glow_tts

HERE = Path(__file__).resolve().parent


def _config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def _flow_trace():
    """One engine.decode span (100-200 us) on thread 1 that launches a 50 us
    kernel, and a 40 us kernel launched outside it."""
    from portbench.harness import trace

    def x(cat, name, ts, dur, tid, corr=None):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
                "args": {} if corr is None else {"correlation": corr}}

    events = [x("user_annotation", "engine.decode", 100, 100, 1),
              x("cuda_runtime", "cudaLaunchKernel", 110, 2, 1, 1), x("kernel", "k1", 120, 50, 7, 1),
              x("cuda_runtime", "cudaLaunchKernel", 250, 2, 1, 2), x("kernel", "k2", 260, 40, 7, 2)]
    return trace.Trace(events)


def test_flow_decode_bound():
    """A ul_batch8 batch's ~5,600 valid frames: ~122 GFLOP of flow decode,
    ~0.74 ms at 3 TF32 operations a FLOP."""
    acoustic = _config("glowtts-harvard.hifigan-ul")["acoustic"]
    flops = glow_tts.glow_decode_flops(acoustic, 5600)
    assert flops / 2800 / 1e6 == pytest.approx(43.7, abs=0.05)
    assert flops / 1e9 == pytest.approx(122, rel=0.01)
    assert 1e3 * peaks.bound_s(flops, 0, 4) == pytest.approx(0.74, abs=0.005)


def test_flow_metrics(monkeypatch):
    """``flow_roofline``: the valid frames' decode bound over the device time
    launched in ``engine.decode`` spans, none for a voice without GlowTTS;
    ``flow_wn_pct.batch``: kernel layers over all flow WaveNet layers in the
    window, none without the counters (a port that lacks them)."""
    from portbench.harness import cell, program_trace
    from portbench.harness import trace as harness_trace

    monkeypatch.setattr(harness_trace, "profiled", harness_trace.profiled)
    ul = _config("glowtts-harvard.hifigan-ul")
    requests = [(100, 650), (80, 521)]
    ctx = types.SimpleNamespace(trace=_flow_trace(), config=ul, requests=requests)
    roofline = cell.load_reader("flow_roofline")
    want = sum(glow_tts.glow_decode_flops(ul["acoustic"], f) for _i, f in requests)
    assert roofline(ctx) == pytest.approx(100 * 3 * want / 495e12 / 50e-6)
    ctx.config = _config("tacotron2-nvidia.waveglow-256")
    assert roofline(ctx) is None
    share = cell.load_reader("flow_wn_pct.batch")
    monkeypatch.setitem(program_trace._window, "counters",
                        {"engine.flow_wn_layers": 96, "engine.flow_wn_kernel_layers": 72})
    assert share(ctx) == pytest.approx(75.0)
    monkeypatch.setitem(program_trace._window, "counters", {"engine.glow_graph_replays": 4})
    assert share(ctx) is None
