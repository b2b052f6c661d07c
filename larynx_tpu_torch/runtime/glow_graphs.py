"""GlowTTS's two stages replayed as CUDA graphs, one graph per shape key.

At batch 8, hidden 192 and float32, GlowTTS's encode launches ~475 kernels
and its flow decode ~805, most of them shorter than the host takes to issue
them, so eagerly the card waits on the launches.  :class:`GlowGraphs`
captures each stage once per key and replays it:

  encode  (rows bucket, text bucket, params' dtype, g present)
  decode  (rows bucket, mel bucket, params' dtype, g present)

Only keys on the engine's ``BucketPolicy`` grid are captured, which bounds
the graphs by the grid; the engine runs a shape beyond it eagerly.  The
decode's inputs are padded along the text axis to the grid's largest text
bucket, so that one decode graph serves every text bucket: the durations'
tail is zero and the means' tail repeats their last column, which leaves
every frame's expansion, and the clamped index past the last, as unpadded.

A key's first call runs the stage eagerly once on a side stream (cuDNN's
algorithm choice and the allocator settle), captures it into a private
memory pool, then replays it.  The graph reads static input buffers written
before each replay, host values through pinned copies, and its outputs are
copied into fresh tensors after it: callers keep an encode's outputs across
later replays (``_run_jobs`` encodes every batch before it decodes one), and
several threads can share one engine.  Copy-in, replay and copy-out run
under one lock, captures too; all of it is asynchronous on the current
stream, so the lock holds only while the host enqueues.  The decode's latent
noise is drawn outside the graph, straight into its static buffer, by the
eager stage's own draw, so it is bit-identical.

Counters (``runtime/trace.py``): ``engine.glow_graph_replays`` and
``engine.glow_graph_captures``, the stages replayed and captured, and
``engine.glow_eager`` (:meth:`GlowGraphs.eager`), the stages that an engine
with graphs ran eagerly: beyond the grid, or on a serving mesh.  What a
stage counts while it runs (``engine.flow_wn_layers`` and
``engine.flow_wn_kernel_layers``) is tallied in its captured run and added
again at every replay, the work the replay does; a capture's own runs count
nothing.
"""

import contextlib
import functools
import threading
import typing

import torch

from larynx_tpu_torch.models.glow_tts import model as glow_model
from larynx_tpu_torch.runtime import trace


def capture_cuda_graph(fn):
    """Run ``fn`` once on a side stream, then capture it into a CUDA graph
    with a private memory pool -> (graph, the outputs it writes)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # other threads may launch work while this one captures
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        outputs = fn()
    return graph, outputs


class _Stage:
    """One stage at one key: the static inputs, the graph that reads them
    and the outputs it writes."""

    def __init__(self, fn, inputs: typing.Dict[str, typing.Optional[torch.Tensor]]):
        self.fn, self.inputs = fn, inputs
        self.graph = self.outputs = None
        self.counts: typing.Dict[str, int] = {}  # what the captured run counted

    def _tallied(self):
        with trace.tally() as counts:
            out = self.fn(**self.inputs)
        self.counts = counts  # the last run's: the captured one
        return out

    def run(self, capture) -> tuple:
        """Replay (capturing first, on the first run) -> fresh copies of the
        outputs."""
        if self.graph is None:
            self.graph, self.outputs = capture(self._tallied)
            trace.count("engine.glow_graph_captures")
        self.graph.replay()
        trace.count("engine.glow_graph_replays")
        for name, n in self.counts.items():
            trace.count(name, n)
        return tuple(o.clone() for o in self.outputs)


class GlowGraphs:
    """GlowTTS's encode and flow decode of one engine's params, captured per
    shape key on first use and replayed.  ``capture(fn) -> (graph, outputs)``
    is :func:`capture_cuda_graph`; a test may pass an eager stand-in."""

    def __init__(self, params, cfg, policy, device, capture=capture_cuda_graph):
        self.params, self.cfg, self.policy = params, cfg, policy
        self.device = torch.device(device)
        self.dtype = params["encoder"]["emb"].dtype
        self._capture = capture
        self._lock = threading.Lock()
        self._stages: typing.Dict[tuple, _Stage] = {}

    def encodes(self, rows: int, text: int) -> bool:
        """Whether an encode of [rows, text] ids replays a graph."""
        return rows in self.policy.batch_buckets and text in self.policy.text_buckets

    def decodes(self, rows: int, text: int, mel: int) -> bool:
        """Whether a flow decode of [rows, text] means to ``mel`` frames
        replays a graph."""
        return (rows in self.policy.batch_buckets and text <= self.policy.text_buckets[-1]
                and mel in self.policy.mel_buckets)

    @staticmethod
    def eager() -> None:
        """Count a stage that the engine ran eagerly."""
        trace.count("engine.glow_eager")

    def _guard(self):
        return torch.cuda.device(self.device) if self.device.type == "cuda" else \
            contextlib.nullcontext()

    def _stage(self, key, fn, make_inputs) -> _Stage:
        stage = self._stages.get(key)
        if stage is None:
            stage = self._stages[key] = _Stage(fn, make_inputs())
        return stage

    def _buffer(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    @torch.inference_mode()
    def encode(self, ids: torch.Tensor, lengths: torch.Tensor, scales: torch.Tensor,
               g: typing.Optional[torch.Tensor]) -> tuple:
        """Host ids [B, T], lengths [B] and length scales [B, 1] (pinned on
        CUDA) and ``g`` [B, gin] or None on the device -> ``encode``'s six
        outputs, tensors of their own.  (B, T) must be on the grid
        (:meth:`encodes`)."""
        b, t = ids.shape
        key = ("encode", b, t, self.dtype, g is not None)
        with self._guard(), self._lock:
            stage = self._stage(key, self._encode, lambda: {
                "ids": self._buffer((b, t), ids.dtype),
                "lengths": self._buffer((b,), lengths.dtype),
                "scales": self._buffer((b, 1), scales.dtype),
                "g": None if g is None else self._buffer(g.shape, g.dtype)})
            s = stage.inputs
            for name, src in (("ids", ids), ("lengths", lengths), ("scales", scales)):
                s[name].copy_(src, non_blocking=True)
            if g is not None:
                s["g"].copy_(g)
            return stage.run(self._capture)

    def _encode(self, ids, lengths, scales, g):
        return glow_model.encode(self.params, self.cfg, ids, lengths, length_scale=scales, g=g)

    @torch.inference_mode()
    def decode(self, x_m: torch.Tensor, x_logs: torch.Tensor, w_ceil: torch.Tensor,
               y_lengths: torch.Tensor, g: typing.Optional[torch.Tensor], mel: int,
               scales: torch.Tensor, noise: typing.Optional[torch.Tensor],
               generator: typing.Optional[torch.Generator]) -> tuple:
        """``expand_and_decode`` of an encode's outputs at ``mel`` frames ->
        (mel, z_mask), tensors of their own.  ``scales``: the host's noise
        scales [B, 1, 1] (pinned on CUDA).  The latent noise [B, mel, C] is
        ``noise``, or, when None, drawn from ``generator`` as
        ``expand_and_decode`` draws it.  The key must be on the grid
        (:meth:`decodes`)."""
        b, t, c = x_m.shape
        t_max = self.policy.text_buckets[-1]
        key = ("decode", b, mel, x_m.dtype, g is not None)
        with self._guard(), self._lock:
            stage = self._stage(key, functools.partial(self._decode, mel), lambda: {
                "x_m": self._buffer((b, t_max, c), x_m.dtype),
                "x_logs": self._buffer((b, t_max, c), x_logs.dtype),
                "w_ceil": self._buffer((b, t_max), w_ceil.dtype),
                "y_lengths": self._buffer((b,), y_lengths.dtype),
                "scales": self._buffer((b, 1, 1), scales.dtype),
                "noise": self._buffer((b, mel, c), x_m.dtype),
                "g": None if g is None else self._buffer(g.shape, g.dtype)})
            s = stage.inputs
            for name, src in (("x_m", x_m), ("x_logs", x_logs)):
                s[name][:, :t].copy_(src)
                if t < t_max:
                    s[name][:, t:].copy_(src[:, t - 1 :])
            s["w_ceil"][:, :t].copy_(w_ceil)
            if t < t_max:
                s["w_ceil"][:, t:].zero_()
            s["y_lengths"].copy_(y_lengths)
            s["scales"].copy_(scales, non_blocking=True)
            if noise is None:
                s["noise"].normal_(generator=generator)  # torch.randn's own draw
            else:
                s["noise"].copy_(noise)
            if g is not None:
                s["g"].copy_(g)
            return stage.run(self._capture)

    def _decode(self, mel, x_m, x_logs, w_ceil, y_lengths, scales, noise, g):
        return glow_model.expand_and_decode(self.params, self.cfg, x_m, x_logs, w_ceil, y_lengths,
                                            mel_max_length=mel, noise_scale=scales, noise=noise,
                                            g=g)
