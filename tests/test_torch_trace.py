"""The port's trace registry (``runtime/trace.py``) and the spans and counters
the engine, kernels, scheduler, stream, server and frontend record, on the
CPU at tiny widths: off it records nothing and opens no profiler range; on,
one ``synthesize_batch`` is one tree of spans with one id; under a profiler
each span but a kernel call's is a ``user_annotation`` on its thread around
the work it launches; the padding counters are exact."""

import asyncio
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import larynx_tpu_torch
from larynx_tpu_torch.audio import AudioSettings
from larynx_tpu_torch.models.glow_tts import model as glow_model
from larynx_tpu_torch.models.glow_tts.config import GlowTTSConfig
from larynx_tpu_torch.models.hifi_gan.config import HiFiGanConfig
from larynx_tpu_torch.models.waveglow.config import WaveGlowConfig
from larynx_tpu_torch.runtime import engine as engine_module
from larynx_tpu_torch.runtime import trace
from larynx_tpu_torch.runtime.buckets import BucketPolicy
from larynx_tpu_torch.runtime.engine import SynthesisEngine, waveglow_area
from larynx_tpu_torch.runtime.scheduler import BatchScheduler
from larynx_tpu_torch.server.app import ServerSettings, create_app
from larynx_tpu_torch.weights import init_params, params_from_jax

VOCODERS = ("hifi_gan", "waveglow")
KERNEL_SPAN = {"hifi_gan": "kernel.mrf_section", "waveglow": "kernel.wn_layer"}
BATCH_CHILDREN = {"engine.pad", "engine.encode", "engine.decode", "engine.lengths_wait",
                  "engine.vocode", "engine.collect", "engine.crop"}
COUNTERS = ("engine.decode_frames", "engine.vocode_frames", "engine.valid_frames")
LENGTHS = (7, 12, 5)


def _engine(kind, seed=0):
    gcfg = GlowTTSConfig(num_symbols=20, hidden_channels=16, filter_channels=32,
                         filter_channels_dp=16, n_layers_enc=2, n_blocks_dec=2, n_block_layers=2)
    vcfg = (HiFiGanConfig(upsample_initial_channel=32) if kind == "hifi_gan"
            else WaveGlowConfig(flows=4, early_every=2, wn_channels=16, wn_layers=2))
    gen = torch.Generator().manual_seed(seed)
    return SynthesisEngine(params_from_jax(init_params(gen, gcfg), "glow_tts"), gcfg,
                           AudioSettings(), vocoder_kind=kind,
                           vocoder_params=params_from_jax(init_params(gen, vcfg), kind),
                           vocoder_cfg=vcfg, device="cpu", seed=seed,
                           policy=BucketPolicy(mel_buckets=(8, 16, 32, 64, 128, 256, 512)))


def _ids(lengths=LENGTHS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 20, size=n).astype(np.int64) for n in lengths]


@pytest.fixture(scope="module", params=VOCODERS)
def engine(request):
    eng = _engine(request.param)
    eng.synthesize_batch(_ids())  # the predicted bucket has an observation
    return eng


@pytest.fixture
def tracing():
    """Tracing on for the test, off and cleared after it."""
    trace.reset()
    trace.enable(True)
    yield trace
    trace.enable(False)
    trace.reset()


def _chrome_events(prof):
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    finally:
        os.unlink(path)


def _counters():
    return {k: trace.counters().get(k, 0) for k in COUNTERS}


def _delta(before):
    after = _counters()
    return {k: after[k] - before[k] for k in COUNTERS}


# ----------------------------------------------------------------------
# the registry


def test_registry_off_returns_the_shared_noop():
    reg = trace.Registry()
    s = reg.span("engine.batch", id=3, rows=2)
    assert s is trace.NOOP
    with s as inner:
        inner.set(bucket=4)
    reg.record("scheduler.queue", time.perf_counter_ns())
    assert reg.snapshot() == {"counters": {}, "spans": {}, "buffer": []}
    reg.count("engine.valid_frames", 5)
    assert reg.stats() == {"counters": {"engine.valid_frames": 5}}


def test_registry_self_time_quantiles_and_buffer():
    reg = trace.Registry(on=True, buffer_spans=4)
    with reg.span("outer", id=7) as outer:
        time.sleep(0.004)
        for _ in range(2):
            with reg.span("inner", k=1):
                time.sleep(0.002)
        outer.set(done=True)
    spans = reg.spans()
    assert [s["name"] for s in spans] == ["inner", "inner", "outer"]
    root = spans[-1]
    assert root["parent"] is None and root["attrs"] == {"done": True}
    for s in spans[:2]:
        assert s["parent"] == root["seq"] and s["id"] == 7 and s["attrs"] == {"k": 1}
        assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] <= root["end_ns"]
    agg = reg.aggregates()
    inner_ns = sum(s["end_ns"] - s["start_ns"] for s in spans[:2])
    assert agg["outer"]["self_ms"] == pytest.approx(
        agg["outer"]["total_ms"] - inner_ns / 1e6, abs=1e-6)
    assert agg["outer"]["self_ms"] >= 4.0
    assert agg["inner"]["count"] == 2 and agg["inner"]["p50_ms"] <= agg["inner"]["max_ms"]
    # a quantile is its bucket's middle: within an eighth of the durations there
    assert 2.0 * 7 / 8 <= agg["inner"]["p95_ms"] <= agg["inner"]["max_ms"]
    for i in range(5):
        reg.record("queued", time.perf_counter_ns() - 1000, id=i)
    assert len(reg.spans()) == 4  # the newest kept
    assert reg.aggregates()["queued"]["count"] == 5
    reg.reset()
    assert reg.spans() == [] and reg.aggregates() == {}


def test_registry_counts_from_many_threads():
    reg = trace.Registry()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [reg.count("n") for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert reg.counters() == {"n": 32000}


def test_env_flag_turns_tracing_on(monkeypatch):
    monkeypatch.setenv("LARYNX_TPU_TRACE", "1")
    assert trace._env_on()
    monkeypatch.setenv("LARYNX_TPU_TRACE", "0")
    assert not trace._env_on()
    monkeypatch.delenv("LARYNX_TPU_TRACE")
    assert not trace._env_on()


# ----------------------------------------------------------------------
# (a) off


def test_off_records_nothing_and_opens_no_profiler_range(engine):
    assert not trace.enabled()
    trace.reset()
    assert trace.span("engine.batch") is trace.NOOP
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.synthesize_batch(_ids())
    names = {e["name"] for e in _chrome_events(prof) if e.get("cat") == "user_annotation"}
    assert not any(n.startswith(("engine.", "kernel.")) for n in names), names
    snap = trace.snapshot()
    assert snap["buffer"] == [] and snap["spans"] == {}
    assert all(snap["counters"].get(k, 0) > 0 for k in COUNTERS)  # counters are always on


# ----------------------------------------------------------------------
# (b) on: the tree of one call


def test_on_one_batch_is_one_tree(engine, tracing):
    engine.synthesize_batch(_ids())
    spans = trace.snapshot()["buffer"]
    roots = [s for s in spans if s["name"] == "engine.batch"]
    assert len(roots) == 1
    root = roots[0]
    assert root["attrs"] == {"rows": 3, "bucket": 4}
    by_seq = {s["seq"]: s for s in spans}
    assert {s["name"] for s in spans if s["parent"] == root["seq"]} == BATCH_CHILDREN
    groups = [s for s in spans if s["name"] == "engine.vocode_group"]
    assert groups and all(by_seq[s["parent"]]["name"] == "engine.vocode" for s in groups)
    kernels = [s for s in spans if s["name"] == KERNEL_SPAN[engine.vocoder_kind]]
    assert kernels and all(by_seq[s["parent"]]["name"] == "engine.vocode_group"
                           for s in kernels)
    for s in spans:
        assert s["id"] == root["id"]
        assert s["tid"] == threading.get_native_id()
        if s is not root:
            parent = by_seq[s["parent"]]
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]
    order = [s["name"] for s in sorted(spans, key=lambda s: s["start_ns"])
             if s["parent"] == root["seq"]]
    assert order[:2] == ["engine.pad", "engine.encode"] and order[-2:] == ["engine.collect",
                                                                             "engine.crop"]
    agg = trace.snapshot()["spans"]
    assert set(agg) == BATCH_CHILDREN | {"engine.batch", "engine.vocode_group",
                                         KERNEL_SPAN[engine.vocoder_kind]}
    assert all(a["self_ms"] >= 0 and a["count"] >= 1 for a in agg.values())
    engine.synthesize_batch(_ids())
    ids = {s["id"] for s in trace.snapshot()["buffer"] if s["name"] == "engine.batch"}
    assert len(ids) == 2  # each call its own id


def test_kernel_span_attributes(engine, tracing):
    engine.synthesize_batch(_ids())
    spans = [s for s in trace.snapshot()["buffer"]
             if s["name"] == KERNEL_SPAN[engine.vocoder_kind]]
    cfg = engine.vocoder_cfg
    if engine.vocoder_kind == "hifi_gan":
        assert len(spans) == len(cfg.upsample_rates)  # every stage at C <= 128
        for s in spans:
            a = s["attrs"]
            assert a["kernel_sizes"] == tuple(cfg.resblock_kernel_sizes)
            assert a["dilations"] == tuple(tuple(d) for d in cfg.resblock_dilation_sizes)
            assert a["convs_per_unit"] == 2 and a["itemsize"] == 4 and a["B"] == 3
        assert [s["attrs"]["C"] for s in spans] == [
            cfg.upsample_initial_channel // 2 ** (i + 1) for i in range(len(spans))]
    else:
        assert len(spans) == cfg.flows * cfg.wn_layers
        layer = engine.vocoder_params["flows"][0]["wn"]["layers"][0]
        for i, s in enumerate(spans):
            a = s["attrs"]
            assert (a["first"], a["last"]) == (i % cfg.wn_layers == 0,
                                               i % cfg.wn_layers == cfg.wn_layers - 1)
            assert a["ch"] == cfg.wn_channels and a["cc"] == layer.w_cond.shape[1]
            assert a["B"] == 3 and a["itemsize"] == layer.w_in.element_size()


# ----------------------------------------------------------------------
# (c) the profiler's clock


def test_spans_are_annotations_around_their_work(engine, tracing, monkeypatch):
    from torch.profiler import ProfilerActivity, profile, record_function

    inner = glow_model.encode

    def probed(*args, **kwargs):
        with record_function("probe.encode"):
            return inner(*args, **kwargs)

    monkeypatch.setattr(glow_model, "encode", probed)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.synthesize_batch(_ids())
    events = _chrome_events(prof)
    notes = [e for e in events if e.get("cat") == "user_annotation"]
    spans = trace.snapshot()["buffer"]
    for name in {s["name"] for s in spans}:
        got = [e for e in notes if e["name"] == name]
        if name.startswith("kernel."):  # a kernel call's span stays out of the profiler
            assert got == [], name
            continue
        assert len(got) == sum(s["name"] == name for s in spans), name
        assert len({e["tid"] for e in got}) == 1, name
    tid = next(e["tid"] for e in notes if e["name"] == "engine.batch")
    (enc,) = [e for e in notes if e["name"] == "engine.encode"]
    (probe,) = [e for e in notes if e["name"] == "probe.encode"]
    assert probe["tid"] == enc["tid"] == tid
    assert enc["ts"] <= probe["ts"] and probe["ts"] + probe["dur"] <= enc["ts"] + enc["dur"]
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["tid"] == tid
           and probe["ts"] <= e["ts"] <= probe["ts"] + probe["dur"]]
    assert len(ops) > 10
    assert all(enc["ts"] <= e["ts"] and e["ts"] + e["dur"] <= enc["ts"] + enc["dur"]
               for e in ops)


# ----------------------------------------------------------------------
# (d) the counters


def _valid_lengths(audio, engine):
    return np.asarray([len(a) // engine.upsample for a in audio])


def test_counters_are_exact(engine, tracing):
    ids = _ids((9, 20, 4, 14, 11), seed=1)
    predicted = engine._predict_mel_bucket(max(len(x) for x in ids), 1.0)
    before = _counters()
    audio = engine.synthesize_batch(ids)
    delta = _delta(before)
    lens = _valid_lengths(audio, engine)
    (dec,) = [s for s in trace.snapshot()["buffer"] if s["name"] == "engine.decode"]
    m = dec["attrs"]["mel_bucket"]
    assert m == predicted and dec["attrs"]["redo"] is False
    b = engine.policy.batch_bucket(len(ids))
    assert delta["engine.decode_frames"] == b * m
    assert delta["engine.valid_frames"] == int(lens.sum())
    area = engine_module.MAX_VOCODE_AREA if engine.vocoder_kind == "hifi_gan" \
        else waveglow_area()
    plan = engine._ragged_group_plan(np.sort(lens)[::-1], len(ids), m, area)
    assert delta["engine.vocode_frames"] == sum(rows * width for _s, rows, width in plan)
    groups = [(s["attrs"]["rows"], s["attrs"]["width"]) for s in trace.snapshot()["buffer"]
              if s["name"] == "engine.vocode_group"]
    assert groups == [(rows, width) for _s, rows, width in plan]


def test_a_mispredict_counts_the_second_decode(engine, tracing):
    ids = _ids((9, 20, 4, 14, 11), seed=2)
    saved = engine._frames_per_token
    engine._frames_per_token = 1e-3  # the prediction falls short
    try:
        predicted = engine._predict_mel_bucket(max(len(x) for x in ids), 1.0)
        before, misses = _counters(), engine._bucket_mispredicts
        audio = engine.synthesize_batch(ids)
    finally:
        engine._frames_per_token = saved
    delta = _delta(before)
    decodes = [s["attrs"] for s in trace.snapshot()["buffer"] if s["name"] == "engine.decode"]
    assert engine._bucket_mispredicts == misses + 1
    assert [d["redo"] for d in decodes] == [False, True]
    exact = engine.policy.mel_bucket(int(_valid_lengths(audio, engine).max()))
    assert [d["mel_bucket"] for d in decodes] == [predicted, exact]
    assert delta["engine.decode_frames"] == engine.policy.batch_bucket(len(ids)) * (
        predicted + exact)
    assert delta["engine.valid_frames"] == int(_valid_lengths(audio, engine).sum())


def test_stream_spans_and_counters(tracing):
    eng = _engine("hifi_gan")
    ids = _ids((30,))[0]
    before = _counters()
    chunks = list(eng.synthesize_stream(ids, chunk_frames=16))
    delta = _delta(before)
    spans = trace.snapshot()["buffer"]
    stream = [s for s in spans if s["name"] == "engine.stream"]
    parts = [s for s in spans if s["name"] == "engine.stream_chunk"]
    assert len(stream) == 1 and stream[0]["attrs"] == {"chunks": len(chunks)}
    assert [s["attrs"]["chunk"] for s in parts] == list(range(len(chunks)))
    assert all(s["id"] == stream[0]["id"] for s in parts)
    assert parts[0]["start_ns"] == stream[0]["start_ns"]
    frames = sum(len(c) for c in chunks) // eng.upsample
    assert delta["engine.valid_frames"] == frames
    assert delta["engine.vocode_frames"] > frames  # each window carries its halo


# ----------------------------------------------------------------------
# (e) the scheduler


def test_scheduler_queue_and_group_spans(tracing):
    eng = _engine("hifi_gan")
    sched = BatchScheduler(max_batch=4, max_wait_ms=50.0)
    try:
        futures = [sched.submit(eng, x) for x in _ids((6, 9, 4, 12, 7, 5), seed=3)]
        for f in futures:
            f.result(timeout=120)
    finally:
        sched.shutdown()
    spans = trace.snapshot()["buffer"]
    queue = [s for s in spans if s["name"] == "scheduler.queue"]
    groups = [s for s in spans if s["name"] == "scheduler.group"]
    assert sorted(s["id"] for s in queue) == list(range(6))
    assert len(groups) == sched.batches_run
    assert sorted(j for g in groups for j in g["attrs"]["jobs"]) == list(range(6))
    assert sum(g["attrs"]["rows"] for g in groups) == sched.jobs_run == 6
    assert all(s["end_ns"] >= s["start_ns"] for s in queue + groups)
    waits = [s for s in spans if s["name"] == "engine.lengths_wait"]
    assert len(waits) == sched.batches_run


# ----------------------------------------------------------------------
# (f) the server and the frontend

STATS_KEYS = {"batches_run", "sentences_run", "sentences_per_batch", "engines", "version"}


def _serve(tmp_path, requests):
    async def go():
        client = TestClient(TestServer(create_app(ServerSettings(
            device="cpu", voices_dir=str(tmp_path), workers=2))))
        await client.start_server()
        try:
            out = []
            for path in requests:
                resp = await client.get(path)
                out.append((resp.status, await resp.read()))
            return out
        finally:
            await client.close()

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(go())
    finally:
        loop.close()


def test_api_stats_keeps_its_keys_and_gains_trace(tmp_path):
    trace.reset()
    (status, body), = _serve(tmp_path, ["/api/stats"])
    stats = json.loads(body)
    assert status == 200 and set(stats) == STATS_KEYS | {"trace"}
    assert set(stats["trace"]) == {"counters"}


def test_api_stats_reports_spans_when_on(tmp_path, tracing):
    out = _serve(tmp_path, ["/version", "/api/tts", "/api/stats"])
    assert [s for s, _ in out] == [200, 500, 200]
    stats = json.loads(out[-1][1])
    assert set(stats) == STATS_KEYS | {"trace"}
    req = stats["trace"]["spans"]["server.request"]
    assert req["count"] == 2  # /api/stats is recorded after it answers
    assert set(req) == {"count", "total_ms", "self_ms", "p50_ms", "p95_ms", "max_ms"}
    routes = [(s["attrs"]["route"], s["attrs"]["status"]) for s in trace.snapshot()["buffer"]
              if s["name"] == "server.request"]
    assert routes == [("GET /version", 200), ("GET /api/tts", 500), ("GET /api/stats", 200)]


def test_frontend_span(monkeypatch, tracing):
    class Model:
        audio_settings = AudioSettings()
        phoneme_to_id = {}

    loads = []

    def load(*args, **kwargs):
        loads.append(time.perf_counter_ns())
        return Model()

    monkeypatch.setattr(larynx_tpu_torch, "get_tts_model", load)
    monkeypatch.setattr(larynx_tpu_torch, "get_vocoder_model", load)
    jobs = larynx_tpu_torch._build_jobs("Hello there. How are you?", "en-us", "low")
    assert len(jobs) == 2
    (span,) = [s for s in trace.snapshot()["buffer"] if s["name"] == "frontend.text"]
    assert span["parent"] is None and span["end_ns"] > span["start_ns"]
    assert len(loads) == 4 and all(t > span["end_ns"] for t in loads)  # loads stay outside


def test_swagger_documents_api_stats_and_its_trace():
    import yaml

    spec = yaml.safe_load((larynx_tpu_torch.server.app._DIR / "swagger.yaml").read_text())
    props = spec["paths"]["/api/stats"]["get"]["responses"]["200"]["content"][
        "application/json"]["schema"]["properties"]
    assert set(props) == STATS_KEYS | {"trace"}
    assert set(props["trace"]["properties"]) == {"counters", "spans"}
