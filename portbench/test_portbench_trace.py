"""The readers of the port's own spans and counters (``harness/program_trace.py``
and ``metrics/{idle_launch_pct,idle_host_pct,launches,decode_pad_x,
vocode_pad_x}.batch.py``): on a synthetic chrome trace their numbers are
exact and the idle split adds up with the remainder to ``idle_pct.batch``;
on a CPU traced window of each cell at tiny widths the port's spans cover
the same work as the harness's ``Ranges`` and give the same kernel bounds;
the port's tracing is switched and read outside the window; without the
port's registry the harness runs as before."""

import contextlib
import json
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from larynx_tpu_torch.runtime import trace as port_trace
from portbench import entries
from portbench.conftest import E2E, tiny_config, tiny_mix
from portbench.counts import mrf, peaks, wn
from portbench.harness import cell, program_trace
from portbench.harness import trace as harness_trace

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in BENCH["workloads"]}
KIND = {c["name"]: json.loads((HERE.parent / c["file"]).read_text())["vocoder"]["kind"]
        for c in BENCH["configs"]}
NEW = ("idle_launch_pct.batch", "idle_host_pct.batch", "launches.batch", "decode_pad_x.batch",
       "vocode_pad_x.batch")
SEED = 4_000_000_123


@pytest.fixture(autouse=True)
def harness_window_restored(monkeypatch):
    """The harness's ``profiled`` as it was before the test, after it: the
    readers loaded here install the port's window on it."""
    monkeypatch.setattr(harness_trace, "profiled", harness_trace.profiled)


def _x(cat, name, ts, dur, tid, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _synthetic_events():
    """A 1000 us window on thread 1: two engine calls, four kernels and a copy
    (device stream 7), the harness's own ranges, and another thread's span.
    Idle on the engine's thread: host 165 us (pad 50 + lengths wait 20 +
    collect 35 + crop 30 + the call's own 10 + pad 20), launch 180 us
    (encode 50 + decode 40 + vocode 30 + encode 20 + 40), outside the
    calls 400 us; busy 255 us."""
    ev = []
    for name, s, e in [("engine.batch", 100, 600), ("engine.pad", 100, 150),
                       ("engine.encode", 150, 250), ("engine.lengths_wait", 250, 320),
                       ("engine.decode", 320, 400), ("engine.vocode", 400, 500),
                       ("engine.collect", 500, 560),
                       ("engine.crop", 560, 590), ("engine.batch", 700, 800),
                       ("engine.pad", 700, 720), ("engine.encode", 720, 800),
                       ("batch", 90, 610), ("glow", 140, 410), ("batch", 690, 810)]:
        ev.append(_x("user_annotation", name, s, e - s, 1))
    ev.append(_x("user_annotation", "scheduler.queue", 0, 1000, 2))
    for corr, (launch, s, e, cat) in enumerate([(160, 200, 300, "kernel"),
                                                (330, 360, 420, "kernel"),
                                                (430, 450, 520, "kernel"),
                                                (535, 540, 545, "gpu_memcpy"),
                                                (725, 740, 760, "kernel")]):
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", launch, 2, 1, corr))
        ev.append(_x(cat, f"op{corr}", s, e - s, 7, corr))
    return ev


def _ctx(events, window_s=1000e-6):
    return types.SimpleNamespace(trace=harness_trace.Trace(events), window_s=window_s,
                                 n_batches=2, requests=[], config=None, mix=None)


def test_idle_split_on_a_synthetic_trace():
    ctx = _ctx(_synthetic_events())
    assert ctx.trace.busy_s == pytest.approx(255e-6)
    split = program_trace.idle_split(ctx.trace)
    assert split["host"] == pytest.approx(165e-6)
    assert split["launch"] == pytest.approx(180e-6)
    idle = cell.load_reader("idle_pct.batch")(ctx)
    launch = cell.load_reader("idle_launch_pct.batch")(ctx)
    host = cell.load_reader("idle_host_pct.batch")(ctx)
    assert (idle, launch, host) == pytest.approx((74.5, 18.0, 16.5))
    assert idle - launch - host == pytest.approx(40.0)  # outside the calls: 400 of 1000 us


def test_launches_per_batch_on_a_synthetic_trace():
    ctx = _ctx(_synthetic_events())
    assert cell.load_reader("launches.batch")(ctx) == 2.0  # 4 kernels, 2 calls; copies aside


def test_innermost_segments():
    spans = [(0, 10, "a"), (2, 4, "b"), (3, 4, "c"), (6, 12, "d"), (20, 30, "e")]
    assert program_trace.innermost(spans) == [
        (0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 6, "a"), (6, 10, "d"), (20, 30, "e")]


def test_readers_without_the_port_spans_read_nothing():
    events = [e for e in _synthetic_events() if not e["name"].startswith("engine.")]
    ctx = _ctx(events)
    for name in ("idle_launch_pct.batch", "idle_host_pct.batch", "launches.batch"):
        assert cell.load_reader(name)(ctx) is None, name
    assert cell.load_reader("idle_pct.batch")(ctx) == pytest.approx(74.5)


def test_padding_ratios(monkeypatch):
    monkeypatch.setattr(program_trace, "_window", {"counters": {
        "engine.decode_frames": 8 * 1024, "engine.vocode_frames": 5 * 768 + 3 * 384,
        "engine.valid_frames": 4096}})
    assert cell.load_reader("decode_pad_x.batch")(None) == 2.0
    assert cell.load_reader("vocode_pad_x.batch")(None) == 1.21875
    monkeypatch.setattr(program_trace, "_window", {})
    assert cell.load_reader("decode_pad_x.batch")(None) is None
    assert cell.load_reader("vocode_pad_x.batch")(None) is None


# ----------------------------------------------------------------------
# a CPU traced window of each cell at tiny widths


@pytest.fixture(scope="module", params=sorted(CELLS))
def traced(request):
    """(cell, chrome events, Ranges' calls, the port's window spans and
    counters) of a 0.5 s profiled window after the cell's warm-up."""
    name = request.param
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    captured = []
    inner = harness_trace.Trace
    mp.setattr(harness_trace, "Trace", lambda events: captured.append(events) or inner(events))
    try:
        torch.set_grad_enabled(False)
        mix = tiny_mix(CELLS[name]["traffic"])
        s = cell.Setup(tiny_config(KIND[CELLS[name]["config"]]), mix, SEED, torch.device("cpu"))
        entry = entries.load(mix["entry"])
        entry.warm(s, 0.2)
        with harness_trace.Ranges() as ranges:
            with program_trace.profiled(ranges):
                entry.window(s, 0.5, mark=torch.profiler.record_function)
        calls = {"mrf": list(ranges.mrf_calls), "wn": list(ranges.wn_calls)}
        yield name, captured[0], calls, program_trace.window_spans(), \
            program_trace.window_counters()
    finally:
        torch.set_grad_enabled(True)
        mp.undo()


def _ops_inside(events, names):
    """(ts, name) of the engine thread's CPU ops inside any range in ``names``."""
    tid = next(e["tid"] for e in events if e.get("name") == "engine.batch")
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation" and e["name"] in names and e["tid"] == tid]
    return {(e["ts"], e["name"]) for e in events
            if e.get("cat") == "cpu_op" and e["tid"] == tid
            and any(s <= e["ts"] and e["ts"] + e["dur"] <= t for s, t in ranges)}


def test_port_spans_cover_the_glow_and_vocode_ranges(traced):
    _name, events, _calls, _spans, _counters = traced
    glow = _ops_inside(events, {"glow"})
    assert len(glow) > 50
    # the ids' copies are engine.pad's, the lengths' wait engine.lengths_wait's
    assert glow == _ops_inside(events, {"engine.pad", "engine.encode", "engine.decode",
                                        "engine.lengths_wait"})
    vocode = _ops_inside(events, {"vocode"})
    assert len(vocode) > 50 and vocode == _ops_inside(events, {"engine.vocode"})


def _bound_from_calls(calls):
    bound = 0.0
    for c, b, t, itemsize, stage in calls["mrf"]:
        taps = mrf.section_taps(stage.kernel_sizes, stage.dilations_per_block, stage.convs_per_unit)
        bound += peaks.bound_s(mrf.section_flops(b, t, c, taps), mrf.section_bytes(
            b, t, c, stage.kernel_sizes, stage.dilations_per_block, stage.convs_per_unit,
            itemsize), itemsize)
    for b, t, layer, first, last in calls["wn"]:
        ch, cc, rs_out = layer.w_in.shape[1], layer.w_cond.shape[1], layer.b_rs.numel()
        n_weights = sum(x.numel() for x in (layer.w_in, layer.w_cond, layer.w_rs,
                                            layer.bias_a, layer.b_rs))
        itemsize = layer.w_in.element_size()
        bound += peaks.bound_s(wn.layer_flops(b, t, ch, cc, rs_out), wn.layer_bytes(
            b, t, ch, cc, rs_out, first, last, n_weights, itemsize), itemsize)
    return bound


def test_kernel_spans_give_the_ranges_bound(traced):
    _name, events, calls, spans, _counters = traced
    kernel_spans = [s for s in spans if s["name"].startswith("kernel.")]
    assert len(kernel_spans) == len(calls["mrf"]) + len(calls["wn"]) > 0
    assert all(program_trace.kernel_bound_s(s) > 0 for s in kernel_spans)
    assert program_trace.kernel_bound_s(next(s for s in spans if s["name"] == "engine.batch")) \
        is None
    bound = sum(program_trace.kernel_bound_s(s) for s in kernel_spans)
    assert bound == pytest.approx(_bound_from_calls(calls), rel=1e-12)
    # the kernel calls' spans stay out of the profiler's trace
    assert not any(e.get("name", "").startswith("kernel.") for e in events)


def test_tracing_is_switched_and_read_outside_the_window(monkeypatch):
    registry = port_trace.Registry()
    registry.count("engine.valid_frames", 5)
    with registry.span("engine.batch"):
        pass  # off: nothing buffered
    registry.enable(True)
    with registry.span("engine.pad"):
        pass  # a span of before the window, reset away
    registry.enable(False)
    seen = []

    @contextlib.contextmanager
    def window(ranges):
        seen.append((registry.enabled(), registry.spans()))
        yield {"window_s": 1.0}
        # counted after the window's work: read only once the window has closed
        registry.count("engine.valid_frames", 3)
        seen.append(registry.enabled())

    monkeypatch.setattr(program_trace, "_registry", lambda: registry)
    monkeypatch.setattr(program_trace, "_PROFILED", window)
    with program_trace.profiled(None) as out:
        with registry.span("engine.batch", id=1):
            registry.count("engine.valid_frames", 7)
    assert out == {"window_s": 1.0}
    assert seen == [(True, []), True]  # on and reset when the window opens, on till it closes
    assert not registry.enabled()
    assert program_trace.window_counters() == {"engine.valid_frames": 10}
    assert [s["name"] for s in program_trace.window_spans()] == ["engine.batch"]


def test_window_counters(traced):
    _name, events, _calls, spans, counters = traced
    batches = [s for s in spans if s["name"] == "engine.batch"]
    decodes = [s["attrs"] for s in spans if s["name"] == "engine.decode"]
    assert len(batches) == sum(e.get("name") == "engine.batch" for e in events) > 0
    assert counters["engine.decode_frames"] == sum(d["rows"] * d["mel_bucket"] for d in decodes)
    assert counters["engine.vocode_frames"] >= counters["engine.valid_frames"] > 0


# ----------------------------------------------------------------------
# whole traced runs on the CPU


def _run(workload, readers):
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    w = CELLS[workload]
    result, compared = cell.run_cell(
        {"name": workload, "end_to_end": E2E}, tiny_config(KIND[w["config"]]),
        tiny_mix(w["traffic"]), limits, readers, SEED, 0.5, True, torch.device("cpu"),
        time.perf_counter())
    assert compared > 0 and result["correct"], result["checks"]
    return result


def _readers():
    return {m["name"]: (cell.load_reader(m["name"]), m["unit"]) for m in BENCH["per_layer"]}


@pytest.fixture
def no_cuda_sync(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def test_traced_run_reads_the_counters(no_cuda_sync):
    result = _run("ul_batch8", _readers())
    metrics = result["metrics"]
    assert metrics["decode_pad_x.batch"]["value"] >= 1.0
    assert metrics["vocode_pad_x.batch"]["value"] >= 1.0
    assert "mfu" in metrics
    # no device on the CPU: the device readers read nothing
    for name in ("idle_launch_pct.batch", "idle_host_pct.batch", "launches.batch"):
        assert name not in metrics


def test_without_the_registry_the_harness_runs_as_before(no_cuda_sync, monkeypatch):
    import larynx_tpu_torch.runtime

    monkeypatch.delattr(larynx_tpu_torch.runtime, "trace")
    monkeypatch.setitem(sys.modules, "larynx_tpu_torch.runtime.trace", None)
    assert program_trace.set_tracing(True) is None and program_trace.snapshot() is None
    result = _run("ul_batch8", _readers())
    assert not set(NEW) & set(result["metrics"])
    assert "mfu" in result["metrics"] and result["breakdown"]["device_ops"] == []
    assert program_trace.window_counters() is None
