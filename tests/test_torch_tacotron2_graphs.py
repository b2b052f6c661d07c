"""Tacotron2's encode replayed as CUDA graphs
(``runtime/tacotron2_engine.py::Tacotron2Graphs``): on the CPU through an
eager stand-in whose replay writes the first run's output tensors, as a
graph's replay writes its static outputs, a key captures once and then
replays its encode; ``test_replay_equals_the_eager_decode`` holds the
engine's decode with the replayed encode to the eager one bit for bit, on
the CPU through the stand-in and, marked ``card``, through real graphs and
the step kernel on the card at NVIDIA's widths (this file imports no JAX:
``python -m pytest tests/test_torch_tacotron2_graphs.py -m card
--noconftest``)."""

import threading

import numpy as np
import pytest
import torch

from larynx_tpu_torch.audio import AudioSettings
from larynx_tpu_torch.models.tacotron2 import Tacotron2Config
from larynx_tpu_torch.runtime.engine import SynthesisEngine
from larynx_tpu_torch.runtime.tacotron2_engine import Tacotron2Graphs
from larynx_tpu_torch.weights import init_params, params_from_jax

TINY = dict(num_symbols=40, symbols_embedding_dim=32, encoder_embedding_dim=32,
            encoder_n_convolutions=2, prenet_dim=16, attention_rnn_dim=48, decoder_rnn_dim=48,
            attention_dim=24, attention_location_n_filters=8, attention_location_kernel_size=15,
            postnet_embedding_dim=32, postnet_n_convolutions=3, max_decoder_steps=40)
COUNTS = {"replays": 0, "captures": 0}


class EagerGraph:
    """A CUDA graph's stand-in: replay runs the block again and writes its
    outputs into the first run's tensors."""

    def __init__(self, fn):
        self.fn, self.outputs = fn, fn()

    def replay(self):
        COUNTS["replays"] += 1
        for out, new in zip(self.outputs, self.fn()):
            out.copy_(new)


def eager_capture(fn):
    COUNTS["captures"] += 1
    graph = EagerGraph(fn)
    return graph, graph.outputs


def _engine(device="cpu", graphs=True, gate=-50.0):
    """A mel-only engine: tiny on the CPU, at NVIDIA's widths on CUDA.  On
    the CPU ``graphs`` gives the engine the stand-in graphs; on CUDA the
    engine has real ones, taken off for the eager reference."""
    cfg = Tacotron2Config(**(TINY if torch.device(device).type == "cpu" else {}))
    tree = init_params(torch.Generator().manual_seed(0), cfg)
    tree["decoder"]["gate"]["b"][:] = gate
    eng = SynthesisEngine(params_from_jax(tree, "tacotron2"), cfg, AudioSettings(),
                          vocoder_kind="none", device=device)
    if not graphs:
        eng._t2_graphs = None
    elif eng._t2_graphs is None:
        eng._t2_graphs = Tacotron2Graphs(eng.glow_params, cfg, capture=eager_capture)
    return eng


def _ids(lengths, seed=0, symbols=40):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, symbols, size=n).astype(np.int64) for n in lengths]


def _decode(eng, ids, **kwargs):
    out, _ = eng.encode_launch(ids, **kwargs)
    return out.mel, out.lengths.numpy()


def _counts():
    return COUNTS["replays"], COUNTS["captures"]


def test_a_key_captures_once_then_replays_its_blocks():
    """Replays and captures of the encode, one a batch, keyed by (rows, text
    bucket); the decode's blocks replay nothing."""
    eng = _engine()
    before = _counts()
    _decode(eng, _ids((9, 14, 6)), max_decoder_steps=56)
    assert np.subtract(_counts(), before).tolist() == [1, 1]
    _decode(eng, _ids((5, 12, 7), seed=1), max_decoder_steps=40)  # the same key
    _decode(eng, _ids((3, 7), seed=2), max_decoder_steps=16)  # another rows bucket
    assert np.subtract(_counts(), before).tolist() == [3, 2]


@pytest.fixture
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: real CUDA graphs are captured only there")
    return request.param


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.card)],
                         indirect=True)
def test_replay_equals_the_eager_decode(device, monkeypatch):
    """Two text buckets, budgets that end inside a block (half blocks and
    eager rests), a live gate that ends the decode early, seeded rows, and
    more threads than cores sharing one engine."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    symbols = 40 if device == "cpu" else 148
    eng, ref = _engine(device), _engine(device, graphs=False)
    cases = [(_ids((9, 14, 6), symbols=symbols), {"max_decoder_steps": [56, 20, 35]}),
             (_ids((20, 30), seed=1, symbols=symbols), {"max_decoder_steps": 37}),
             (_ids((5, 7, 3), seed=2, symbols=symbols), {"seed": [11, None, 13]})]
    for ids, kwargs in cases:
        for a, b in zip(_decode(eng, ids, **kwargs), _decode(ref, ids, **kwargs)):
            assert np.array_equal(np.asarray(a.cpu() if torch.is_tensor(a) else a),
                                  np.asarray(b.cpu() if torch.is_tensor(b) else b))

    live, live_ref = _engine(device, gate=0.0), _engine(device, graphs=False, gate=0.0)
    ids = _ids((9, 14, 6), seed=4, symbols=symbols)
    got, want = _decode(live, ids, max_decoder_steps=64), _decode(live_ref, ids,
                                                                   max_decoder_steps=64)
    assert torch.equal(got[0].cpu(), want[0].cpu()) and np.array_equal(got[1], want[1])

    pool = [_ids(ls, seed=i, symbols=symbols) for i, ls in enumerate(((5, 7), (20, 3), (6, 2)))]
    want = [_decode(ref, ids, max_decoder_steps=33)[0].cpu() for ids in pool]
    errors = []

    def worker(k):
        try:
            for j in [(k + i) % len(pool) for i in range(2 * len(pool))]:
                if not torch.equal(_decode(eng, pool[j], max_decoder_steps=33)[0].cpu(),
                                   want[j]):
                    errors.append(f"thread {k}, batch {j}")
        except Exception as exc:  # noqa: BLE001 (reported below)
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    assert not errors, errors
