"""GlowTTS's encode and flow decode replayed as CUDA graphs per bucket key
(``larynx_tpu_torch/runtime/glow_graphs.py``).

On the CPU the engine's graph cache runs with its capture replaced by an
eager stand-in whose replay writes the first run's output tensors, as a
graph's replay writes its static outputs: a key's second call replays and
does not capture, two calls at one key return tensors of their own, shapes
beyond the grid, the mesh and a CPU engine run eagerly, and the three
counters count what they say, and a replay counts what its capture
counted.  ``test_replay_equals_the_eager_stages``
holds the replayed stages to the eager ones bit for bit: on the CPU through
the stand-in (the static buffers, the text axis's padding, the noise), and,
marked ``card``, through real CUDA graphs at GlowTTS's published widths
(skipped without a CUDA device).  This file imports no JAX; run the card
cases on the chip as
``python -m pytest tests/test_torch_glow_graphs.py -m card --noconftest``.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from larynx_tpu_torch.audio import AudioSettings
from larynx_tpu_torch.models.glow_tts.config import GlowTTSConfig
from larynx_tpu_torch.parallel.mesh import ServingMesh
from larynx_tpu_torch.runtime import trace
from larynx_tpu_torch.runtime.buckets import BucketPolicy
from larynx_tpu_torch.runtime.engine import SynthesisEngine
from larynx_tpu_torch.runtime.glow_graphs import GlowGraphs
from larynx_tpu_torch.weights import init_params, params_from_jax

COUNTERS = ("engine.glow_graph_replays", "engine.glow_graph_captures", "engine.glow_eager")
TINY = dict(num_symbols=20, hidden_channels=16, filter_channels=32, filter_channels_dp=16,
            n_layers_enc=2, n_blocks_dec=2, n_block_layers=2)
POLICY = BucketPolicy(text_buckets=(8, 16, 32), mel_buckets=(16, 32, 64, 128, 256),
                      batch_buckets=(1, 2, 4))


class EagerGraph:
    """A CUDA graph's stand-in: replay runs the stage again and writes its
    outputs into the first run's tensors."""

    def __init__(self, fn):
        self.fn, self.outputs = fn, fn()

    def replay(self):
        for out, new in zip(self.outputs, self.fn()):
            out.copy_(new)


def eager_capture(fn):
    graph = EagerGraph(fn)
    return graph, graph.outputs


def _engine(device="cpu", graphs=True, speakers=1, mesh=None, seed=0, half=False):
    """A mel-only engine: tiny on the CPU, at the published widths on CUDA.
    On the CPU ``graphs`` puts the stand-in graph cache on the engine; on
    CUDA the engine has real graphs, taken off for the eager reference."""
    size = TINY if torch.device(device).type == "cpu" else {}
    cfg = GlowTTSConfig(n_speakers=speakers, gin_channels=8 if speakers > 1 else 0,
                        **dict({"num_symbols": 20}, **size))
    params = params_from_jax(init_params(torch.Generator().manual_seed(seed), cfg), "glow_tts")
    eng = SynthesisEngine(params, cfg, AudioSettings(), vocoder_kind="none", device=device,
                          seed=7, mesh=mesh, policy=POLICY if size else None, half=half)
    if not graphs:
        eng._glow_graphs = None
    elif eng._glow_graphs is None:
        eng._glow_graphs = GlowGraphs(eng.glow_params, cfg, eng.policy, eng.device,
                                      capture=eager_capture)
    return eng


def _ids(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 20, size=n).astype(np.int64) for n in lengths]


def _delta(before):
    now = trace.counters()
    return tuple(now.get(k, 0) - before.get(k, 0) for k in COUNTERS)


def _bits(t):
    """A tensor's bit pattern (floats viewed as integers of their width)."""
    if t.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        return t.contiguous().view(ints[t.element_size()])
    return t


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(_bits(x), _bits(y))


def _synth(eng, ids, speakers=None, **decode):
    """Encode, then decode at the exact bucket -> encode's outputs + (mel, z_mask)."""
    out, y_lengths, g = eng.encode_batch(ids, length_scale=1.3, speaker_ids=speakers)
    mel = eng.decode_launch(out, y_lengths, g, len(ids), noise_scale=0.667, **decode)
    return tuple(out) + tuple(mel)


def test_a_key_captures_once_then_replays():
    eng = _engine()
    before = trace.counters()
    _synth(eng, _ids((5, 7)), mel_bucket_override=64)
    assert _delta(before) == (2, 2, 0)
    _synth(eng, _ids((3, 8), seed=1), mel_bucket_override=64)  # the same keys
    assert _delta(before) == (4, 2, 0)


def test_a_replay_counts_what_its_capture_counted():
    """The flow's WaveNet layers that a decode counts are counted once a
    replay, the capture's own runs none."""
    eng = _engine()
    per_decode = eng.glow_cfg.n_blocks_dec * eng.glow_cfg.n_block_layers
    before = trace.counters().get("engine.flow_wn_layers", 0)
    _synth(eng, _ids((5, 7)), mel_bucket_override=64)  # capture, then the first replay
    _synth(eng, _ids((3, 8), seed=1), mel_bucket_override=64)
    assert trace.counters()["engine.flow_wn_layers"] - before == 2 * per_decode


def test_two_calls_at_one_key_return_tensors_of_their_own():
    eng = _engine()
    first = _synth(eng, _ids((5, 7)), mel_bucket_override=64)
    kept = [t.clone() for t in first]
    second = _synth(eng, _ids((6, 4), seed=1), mel_bucket_override=64)
    _same(first, kept)
    assert not torch.equal(first[0], second[0]) and not torch.equal(first[-2], second[-2])
    stage_outs = [o for s in eng._glow_graphs._stages.values() for o in s.outputs]
    for t in first + second:
        assert all(t.data_ptr() != o.data_ptr() for o in stage_outs)


@pytest.mark.parametrize("case", ["text", "rows", "mel"])
def test_beyond_the_grid_runs_eagerly(case):
    lengths, decode, want = {
        "text": ((40, 5), {}, (0, 0, 2)),  # text bucket 64
        "rows": ((5,) * 5, {}, (0, 0, 2)),  # rows bucket 8
        "mel": ((5, 7), {"mel_bucket_override": 512}, (1, 1, 1)),
    }[case]
    eng, ref = _engine(), _engine(graphs=False)
    before = trace.counters()
    out = _synth(eng, _ids(lengths), **decode)
    assert _delta(before) == want
    _same(out, _synth(ref, _ids(lengths), **decode))


def test_the_mesh_runs_eagerly():
    eng = _engine(mesh=ServingMesh(["cpu"] * 2))
    before = trace.counters()
    out, y_lengths, g = eng.encode_batch(_ids((5, 7, 3)))
    eng.decode_launch(out, y_lengths, g, 3)
    assert _delta(before) == (0, 0, 2)
    assert not eng._glow_graphs._stages


def test_a_cpu_engine_runs_eagerly_and_counts_nothing():
    eng = SynthesisEngine(
        params_from_jax(init_params(torch.Generator().manual_seed(0), GlowTTSConfig(**TINY)),
                        "glow_tts"),
        GlowTTSConfig(**TINY), AudioSettings(), vocoder_kind="none", device="cpu")
    assert eng._glow_graphs is None
    before = trace.counters()
    _synth(eng, _ids((5, 7)))
    assert _delta(before) == (0, 0, 0)


@pytest.fixture
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: real CUDA graphs are captured only there")
    return request.param


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.card)],
                         indirect=True)
def test_replay_equals_the_eager_stages(device, monkeypatch):
    """Two text keys, each decoded at two mel buckets; per-row seeded noise;
    a prediction that falls short, decoded again at the exact bucket; a
    multi-speaker ``g``; GlowTTS in bfloat16 (``half``); more threads than
    cores sharing one engine."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    eng, ref = _engine(device), _engine(device, graphs=False)
    before = trace.counters()
    for lengths in ((5, 7, 3), (20, 12)):
        ids = _ids(lengths)
        exact = _synth(ref, ids)
        m = exact[-2].shape[1]
        _same(_synth(eng, ids), exact)
        wider = eng.policy.mel_bucket(m + 1)
        _same(_synth(eng, ids, mel_bucket_override=wider),
              _synth(ref, ids, mel_bucket_override=wider))
        seeds = [11, None, 13][: len(ids)]
        _same(_synth(eng, ids, row_seeds=seeds), _synth(ref, ids, row_seeds=seeds))

    ids = _ids((30, 4), seed=3)
    got, want = [], []
    for e, out in ((eng, got), (ref, want)):
        e._frames_per_token = 1e-3  # the predicted bucket falls short
        enc, g = e.encode_launch(ids, length_scale=4.0)
        out.extend(e.decode_launch_predicted(enc, g, 2, 30, length_scale=4.0)[:2])
        assert e._bucket_mispredicts == 1
    _same(got, want)
    assert _delta(before)[::2] == (2 * 6 + 3, 0)  # replays, eager

    eng_s, ref_s = _engine(device, speakers=3), _engine(device, graphs=False, speakers=3)
    for speakers in ([2, 0], [1, 1]):
        _same(_synth(eng_s, _ids((6, 8)), speakers),
              _synth(ref_s, _ids((6, 8)), speakers))

    eng_h, ref_h = _engine(device, half=True), _engine(device, graphs=False, half=True)
    _same(_synth(eng_h, _ids((5, 7, 3))), _synth(ref_h, _ids((5, 7, 3))))

    # more threads than the machine has cores, switching often
    pool = [_ids(ls, seed=i) for i, ls in enumerate(((5, 7), (20, 3), (6, 2)))]
    want = [_synth(ref, ids) for ids in pool]
    n = (os.cpu_count() or 1) + 1
    got, errors = {}, []

    def worker(k):
        order = [(k + i) % len(pool) for i in range(2 * len(pool))]
        try:
            got[k] = [(j, _synth(eng, pool[j])) for j in order]
        except Exception as exc:  # noqa: BLE001 (raised again below)
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert len(got) == n
    for outs in got.values():
        for j, out in outs:
            _same(out, want[j])
