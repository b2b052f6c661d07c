"""The Tacotron2 cell's pieces on the CPU: the plain reference against the
port's ``infer`` at a tiny size, the decoder step's counts against a hand
count at NVIDIA's widths, the three new readers on a synthetic trace, the
configuration against the port's defaults, and the ``ar_batch`` entry at
tiny widths: the sound path correct at the cell's limits, stops read a
frame late not, and the controls running."""

import copy
import dataclasses
import json
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.conftest import E2E, tiny_mix
from portbench.counts import peaks
from portbench.counts import tacotron2 as counts
from portbench.entries import ar_batch
from portbench.harness import cell, program_trace
from portbench.harness import trace as harness_trace
from portbench.kinds import nvidia_tacotron2 as kind
from portbench.reference import ar_rules
from portbench.reference import tacotron2 as reference

HERE = Path(__file__).resolve().parent
CONFIG = json.loads((HERE / "configs" / "tacotron2-nvidia.waveglow-256.json").read_text())
LIMITS = json.loads((HERE / "limits" / "t2wg_batch8.json").read_text())
NVIDIA = CONFIG["acoustic"]
SMALL = dict(symbols_embedding_dim=32, encoder_embedding_dim=32, prenet_dim=16,
             attention_rnn_dim=48, decoder_rnn_dim=48, attention_dim=24,
             attention_location_n_filters=8, attention_location_kernel_size=15,
             postnet_embedding_dim=32)
SEED = 4_000_000_123


def tiny_config():
    cfg = copy.deepcopy(CONFIG)
    cfg["acoustic"].update(SMALL)
    cfg["vocoder"].update(wn_channels=64, wn_layers=4, flows=4, early_every=2)
    return cfg


@pytest.fixture(autouse=True)
def harness_window_restored(monkeypatch):
    monkeypatch.setattr(harness_trace, "profiled", harness_trace.profiled)


def test_the_configuration_is_the_ports_nvidia_defaults():
    from larynx_tpu_torch.models.tacotron2.config import Tacotron2Config

    want = dataclasses.asdict(Tacotron2Config())
    assert {k: NVIDIA[k] for k in want} == want
    assert NVIDIA["n_sqz"] == 1 and CONFIG["reduced"] == []
    wg = json.loads((HERE / "configs" / "glowtts-harvard.waveglow-256.json").read_text())
    assert CONFIG["vocoder"] == wg["vocoder"]


def test_the_reference_matches_the_ports_infer():
    """Each row alone in float64 against the port's batched float32 decode
    at the same masks: 1e-5 over 30 steps (float32's rounding, carried from
    step to step)."""
    from larynx_tpu_torch.models.tacotron2 import model as tm
    from larynx_tpu_torch.models.tacotron2.config import Tacotron2Config

    cfg = tiny_config()["acoustic"]
    params = kind.weights(cfg, torch.Generator().manual_seed(3), torch.device("cpu"))
    # a live gate: these weights' gate logits fall from -0.02 to -0.07 over the
    # first steps; at -200 x the weights with a bias of -12 each row stops
    # where its own logit first falls below -0.06
    params["decoder"]["gate"]["w"] *= -200.0
    params["decoder"]["gate"]["b"].fill_(-12.0)
    port_cfg = Tacotron2Config(**{k: cfg[k] for k in dataclasses.asdict(Tacotron2Config())})
    rng = np.random.default_rng(3)
    lengths = [9, 14, 6]
    ids = torch.zeros((3, 16), dtype=torch.int64)
    for i, n in enumerate(lengths):
        ids[i, :n] = torch.as_tensor(rng.integers(1, cfg["num_symbols"], size=n))
    keep = torch.stack([ar_rules.keep_masks(cfg, SEED + r, 30) for r in range(3)], dim=2)
    with torch.no_grad():
        mel, out_lengths = tm.infer(params, port_cfg, ids, torch.as_tensor(lengths), 30, keep)
        for r, n in enumerate(lengths):
            want, length = reference.infer(_double(params), cfg, ids[r, :n], keep[:, :, r], 30)
            assert length == int(out_lengths[r])
            torch.testing.assert_close(mel[r, :length].double(), want[:length], rtol=0, atol=1e-5)
    assert len(set(out_lengths.tolist())) > 1


def _double(tree):
    if isinstance(tree, dict):
        return {k: _double(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_double(v) for v in tree]
    return tree.double()


def test_the_kinds_biases_are_nvidias_two():
    cfg = tiny_config()["acoustic"]
    params = kind.weights(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    cell_ = params["decoder"]["attention_rnn"]
    assert torch.equal(cell_["b"], cell_["b_ih"] + cell_["b_hh"])
    assert not torch.equal(cell_["b_ih"], cell_["b_hh"])
    w = params["decoder"]["projection"]["w"].clone()
    kind.calibrate(params, cfg, None, None, 1.0, 6.5)
    assert float(params["decoder"]["gate"]["b"]) == kind.GATE_BIAS
    proj = params["decoder"]["projection"]
    assert torch.equal(proj["w"], w * kind.PROJ_SCALE)
    assert float(proj["b"][0]) == kind.MEL_MEAN[0] and float(proj["b"][-1]) == kind.MEL_MEAN[1]


def test_a_decoder_steps_counts_at_nvidias_widths():
    """Hand count: the attention LSTM 4 x 1024 x (256 + 512 + 1024) + 4096,
    the decoder LSTM 4 x 1024 x (1024 + 512 + 1024) + 4096, the prenet
    80 x 256 + 256 x 256, the attention 128 x 1024 + 32 x 2 x 31 + 128 x 32
    + 128, the projection and gate 81 x (1024 + 512 + 1)."""
    weights = (4 * 1024 * 1792 + 4096) + (4 * 1024 * 2560 + 4096) + (80 * 256 + 256 * 256) \
        + (128 * 1024 + 32 * 2 * 31 + 128 * 32 + 128) + 81 * 1537
    assert counts.step_weights(NVIDIA) == weights == 18_181_777
    b, t = 8, 96
    state = 2 * 1024 + 2 * 1024 + 512 + 2 * t + 80
    assert counts.step_bytes(NVIDIA, b, t) == 4 * (weights + b * (t * 640 + 2 * state))
    assert counts.step_flops(NVIDIA, b, t) == 2 * b * (weights + t * (2 * 31 * 32 + 32 * 128
                                                                      + 128 + 512))
    # 75.0 MB a step at B = 8: bound by HBM, 22.4 us
    assert counts.step_bound_s(NVIDIA, b, t) == pytest.approx(
        counts.step_bytes(NVIDIA, b, t) / peaks.HBM_BYTES_PER_S)
    assert counts.step_bound_s(NVIDIA, b, t) == pytest.approx(22.39e-6, rel=1e-3)
    assert counts.step_flops(NVIDIA, b, t) / counts.F32_FLOPS < 5e-6


def _x(cat, name, ts, dur, tid, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_the_readers_on_a_synthetic_trace(monkeypatch):
    """Two batches: decode spans of 400 and 600 us holding step kernels of
    30 and 50 us, each before the span's last stop read, a postnet kernel
    of 20 us after it; a vocode kernel outside them."""
    ev = [_x("user_annotation", "engine.decode", 100, 400, 1),
          _x("user_annotation", "engine.ar_stop_check", 200, 20, 1),
          _x("user_annotation", "engine.decode", 1000, 600, 1),
          _x("user_annotation", "engine.ar_stop_check", 1050, 10, 1),
          _x("user_annotation", "engine.ar_stop_check", 1200, 30, 1)]
    kernels = [(150, 160, 30), (1100, 1110, 50), (1300, 1310, 20), (1700, 1710, 90)]
    for corr, (launch, s, dur) in enumerate(kernels):
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", launch, 2, 1, corr))
        ev.append(_x("kernel", f"op{corr}", s, dur, 7, corr))
    ctx = types.SimpleNamespace(trace=harness_trace.Trace(ev), window_s=2e-3, n_batches=2,
                                config={"acoustic": NVIDIA})
    assert cell.load_reader("t2_decode_ms.batch")(ctx) == pytest.approx(0.050)
    spans = [{"name": "engine.decode", "start_ns": 0, "end_ns": 30_000_000,
              "attrs": {"family": "tacotron2", "rows": 8, "text_bucket": 96, "steps": 600}},
             {"name": "engine.decode", "start_ns": 0, "end_ns": 10_000_000,
              "attrs": {"family": "tacotron2", "rows": 8, "text_bucket": 64, "steps": 200}},
             {"name": "engine.decode", "start_ns": 0, "end_ns": 5_000_000,
              "attrs": {"rows": 8, "mel_bucket": 512, "redo": False}}]
    monkeypatch.setattr(program_trace, "_window", {"spans": spans, "counters": {
        "engine.ar_frames": 8 * 800, "engine.valid_frames": 5000}})
    bound = 600 * counts.step_bound_s(NVIDIA, 8, 96) + 200 * counts.step_bound_s(NVIDIA, 8, 64)
    assert cell.load_reader("t2_step_roofline")(ctx) == pytest.approx(100 * bound / 80e-6)
    assert cell.load_reader("t2_frames_x.batch")(ctx) == pytest.approx(1.28)
    monkeypatch.setattr(program_trace, "_window", {})
    for name in ("t2_step_roofline", "t2_frames_x.batch"):
        assert cell.load_reader(name)(ctx) is None
    ctx.trace = harness_trace.Trace([e for e in ev if e["name"] != "engine.decode"])
    assert cell.load_reader("t2_decode_ms.batch")(ctx) is None
    monkeypatch.setattr(program_trace, "_window", {"spans": spans})
    assert cell.load_reader("t2_step_roofline")(ctx) is None  # no decode loop in the trace


def _run(config, seed=SEED):
    result, compared = cell.run_cell(
        {"name": "t2wg_batch8", "end_to_end": E2E}, config, tiny_mix("t2batch8"), LIMITS, {},
        seed, 0.6, False, torch.device("cpu"), time.perf_counter())
    assert compared > 0
    return result


def test_the_cell_is_correct_at_tiny_widths():
    result = _run(tiny_config())
    assert result["correct"], result["checks"]


def test_a_stop_read_a_frame_late_is_not_correct(monkeypatch):
    """The cell's gate is held off, so its rows end at their caps: a stop
    length that the engine reads wrong shows as a length mismatch."""
    from larynx_tpu_torch.runtime.tacotron2_engine import Tacotron2Engine

    inner = Tacotron2Engine._read_stops
    monkeypatch.setattr(Tacotron2Engine, "_read_stops",
                        lambda self, stops: inner(self, stops + (stops > 0).to(stops.dtype)))
    result = _run(tiny_config())
    assert not result["correct"] and result["checks"]["length_mismatch"]["value"] > 0


@pytest.mark.parametrize("scope", ["all", "acoustic", "wn"])
def test_the_controls_run(scope):
    s = cell.Setup(tiny_config(), tiny_mix("t2batch8"), SEED, torch.device("cpu"),
                   with_engine=False)
    tally = ar_batch.control(s, scope, LIMITS, 4)
    assert tally.compared > 0 and tally.length_mismatch == 0
    assert tally.audio_err > 0
    with pytest.raises(ValueError):
        ar_batch.control(s, "hifi", LIMITS, 4)
