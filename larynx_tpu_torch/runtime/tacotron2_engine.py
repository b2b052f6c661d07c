"""The engine of an autoregressive voice: Tacotron2 on the batch path.

Tacotron2's output length is known only once the model has run: a row ends
at the frame where its gate fires, or at its step cap.  So its encode launch
(:meth:`Tacotron2Engine.encode_launch`) runs the whole acoustic model of a
batch padded to the batch and text buckets:

  encode   ids [B, T] -> memory, under the ids' mask, so that a padded row
           equals the row run alone
  decode   every row at once, each with its own prenet keep masks and step
           cap; the rows' stops are read on the host once per block of
           ``STOP_CHECK_STEPS`` steps, and the decode ends at the first
           block boundary where every row has stopped and its postnet halo
           is decoded (``models/tacotron2/model.py::decode_blocked``)
  postnet  over the decoded frames, each row's input zeroed from its cap on

On a CUDA device the decoder steps of a block run in one launch of the step
kernel (``ops/tacotron2_step.py``, on weights the engine packs once), and
the encode replays a CUDA graph (:class:`Tacotron2Graphs`).

and returns the mel and the stop lengths, the lengths already on the host
(:class:`ARDecodeOutput`).  The staged calls take it as they take a GlowTTS
encode: ``host_lengths`` returns the stop lengths, ``decode_launch`` and
``decode_launch_predicted`` hand the mel on, and ``vocode_launch``,
``vocode_collect`` and ``crop_rows`` are the engine's own.  The mel handed to
the vocoder is as wide as the mel bucket of the batch's longest row, as the
fallback's vocoders pad a mel (silence past each row's stop).  Tacotron2's mel is the
log-compressed mel the vocoder takes: with NVIDIA's audio section (no
normalisation, no dB conversion, no compression) the engine's mel chain is
the identity.

The rules that decide a row's output, beside the engine's noise rules:

- Prenet keep masks: a row given its own seed s draws them from
  ``SeedSequence([s, 0])``, every other valid row from ``SeedSequence([S,
  0])``, S the call's seed (the engine's when none is given); each draw is
  prefix-stable (``models/tacotron2/model.py::row_keep_masks``).  So a row's
  masks depend on neither its batchmates, nor its place in the batch, nor
  the batch's step budget, and a row seeded s (or unseeded in a call seeded
  s) draws the masks of the fallback's B=1 ``phonemes_to_mels`` at seed s.
- Step cap: ``max_decoder_steps`` (one for the call or one per row), else
  the config's, at most 10 x the row's own text bucket
  (``tacotron2.py::step_budget``, the fallback's rule).
- Length: the frame at which the row's gate first fires, that frame
  included, or its cap; padding rows count as stopped from the start.
- Denoiser: a row's audio is cut to its frames before the denoiser's STFT,
  as the fallback's ``mels_to_audio`` cuts it (``SynthesisEngine._vocode``).

Tacotron2 runs in float32 (the encode and the postnet take TF32 as the
caller sets it, as for the fallback; the step kernel never does); the
vocoder follows :func:`default_vocoder_half`.  The engine
runs on one device.  It has no stream (``stream_text_to_speech`` keeps the
fallback's one peak-normalised chunk per sentence, as the JAX package
streams this voice) and no ``phonemes_to_mels`` (the voice's own surface
is the fallback's).
"""

import threading
import typing

import numpy as np
import torch

from larynx_tpu_torch.device import to_device
from larynx_tpu_torch.models.tacotron2 import model as t2_model
from larynx_tpu_torch.runtime import trace
from larynx_tpu_torch.runtime.engine import HostCopy, SynthesisEngine
from larynx_tpu_torch.runtime.glow_graphs import capture_cuda_graph
from larynx_tpu_torch.tacotron2 import step_budget


class Tacotron2Graphs:
    """Tacotron2's encode replayed as CUDA graphs, captured on first use per
    (rows, text bucket): the encoder's BiLSTM steps run faster than the host
    can launch them one by one.  A graph's input buffers serve one batch at
    a time, under ``lock``.  ``capture(fn) -> (graph, outputs)``: a test may
    pass an eager stand-in."""

    def __init__(self, params, cfg, capture=capture_cuda_graph):
        self.params, self.cfg = params, cfg
        self._capture = capture
        self._encodes: typing.Dict[tuple, tuple] = {}
        self.lock = threading.Lock()

    def encode(self, ids: torch.Tensor, lengths: torch.Tensor):
        """``encode`` of ids [B, T] and lengths [B] on the device -> (memory,
        mask), tensors of their own."""
        key = tuple(ids.shape)
        with self.lock:
            if key not in self._encodes:
                inputs = ids.clone(), lengths.clone()  # the capture's warm-up reads them
                graph, outputs = self._capture(
                    lambda: t2_model.encode(self.params, self.cfg, *inputs))
                self._encodes[key] = inputs, graph, outputs
            inputs, graph, outputs = self._encodes[key]
            inputs[0].copy_(ids)
            inputs[1].copy_(lengths)
            graph.replay()
            return tuple(o.clone() for o in outputs)


class ARDecodeOutput:
    """An autoregressive encode launch's output: the postnet's mel [B, M, C]
    (M the mel bucket of the batch's longest stop), its frame mask [B, M] and ``lengths``,
    the stops' host copy (already on the host)."""

    def __init__(self, mel: torch.Tensor, z_mask: torch.Tensor, lengths: np.ndarray):
        self.mel, self.z_mask = mel, z_mask
        self.lengths = HostCopy(torch.from_numpy(lengths.astype(np.int64)))


class Tacotron2Engine(SynthesisEngine):
    """:class:`SynthesisEngine` for a Tacotron2 voice (``glow_cfg`` a
    ``Tacotron2Config``, its params in the port's layout)."""

    autoregressive = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # the step kernel's weights, packed once; the encode as CUDA graphs
        # (the CPU runs it eagerly)
        self.glow_params = t2_model.pack_params(self.glow_params, self.glow_cfg)
        self._t2_graphs = (Tacotron2Graphs(self.glow_params, self.glow_cfg)
                           if self.device.type == "cuda" else None)

    def step_caps(self, id_seqs, max_decoder_steps=None) -> np.ndarray:
        """Each sentence's step cap (at least 1)."""
        if np.ndim(max_decoder_steps) == 0:
            max_decoder_steps = [max_decoder_steps] * len(id_seqs)
        return np.array([max(1, step_budget(self.glow_cfg, len(ids), steps))
                         for ids, steps in zip(id_seqs, max_decoder_steps)], dtype=np.int64)

    def mask_entropies(self, n: int, b_bucket: int, seed=None):
        """Each batch row's keep-mask entropy (None for a padding row):
        ``seed`` an int (the call's) or one per sentence (None: unseeded)."""
        base, row_seeds = self.seed, [None] * n
        if np.ndim(seed) == 0 and seed is not None:
            base = int(seed)
        elif np.ndim(seed) > 0:
            row_seeds = list(seed)
        return [None if r >= n else [base if row_seeds[r] is None else int(row_seeds[r]), 0]
                for r in range(b_bucket)]

    def _read_stops(self, stops: torch.Tensor) -> np.ndarray:
        trace.count("engine.ar_stop_checks")
        with trace.span("engine.ar_stop_check"):
            return stops.cpu().numpy()

    @torch.inference_mode()
    def encode_launch(self, id_seqs, length_scale=1.0, speaker_ids=None, seed=None,
                      max_decoder_steps=None):
        """Encode, decode and postnet of a batch -> (:class:`ARDecodeOutput`,
        None).  ``seed`` and ``max_decoder_steps`` as in the module's rules;
        Tacotron2 has no length scale or speakers."""
        cfg, params = self.glow_cfg, self.glow_params
        n = len(id_seqs)
        with trace.span("engine.pad"):
            ids, lengths, b_bucket = self._pad_id_arrays(id_seqs)
            caps = np.zeros((b_bucket,), dtype=np.int64)
            caps[:n] = self.step_caps(id_seqs, max_decoder_steps)
            keep = None
            if cfg.p_prenet_dropout > 0.0:
                keep = t2_model.RowKeepMasks(cfg, self.mask_entropies(n, b_bucket, seed),
                                             self.device)
            ids, lengths = to_device(ids, self.device), to_device(lengths, self.device)
        t_bucket = ids.shape[1]
        graphs = self._t2_graphs
        with trace.span("engine.encode", rows=b_bucket, text_bucket=t_bucket):
            memory, mask = (t2_model.encode(params, cfg, ids, lengths) if graphs is None
                            else graphs.encode(ids, lengths))
        with trace.span("engine.decode", family="tacotron2", rows=b_bucket,
                        text_bucket=t_bucket) as span:
            mels, stops, steps, blocks = t2_model.decode_blocked(
                params, cfg, memory, mask, caps, keep, read=self._read_stops)
            frames = torch.arange(steps, device=self.device)
            in_cap = (frames[None, :] < to_device(caps, self.device)[:, None]).to(mels.dtype)
            mel = mels + t2_model.postnet(params, cfg, mels, mask=in_cap)
            m = self.policy.mel_bucket(int(stops[:n].max()))
            mel = torch.nn.functional.pad(mel, (0, 0, 0, max(0, m - steps)))[:, :m]
            z_mask = (torch.arange(m, device=self.device)[None, :]
                      < to_device(stops, self.device)[:, None]).to(mel.dtype)
            span.set(steps=steps, blocks=blocks)
        trace.count("engine.ar_steps", steps)
        trace.count("engine.ar_frames", b_bucket * steps)
        return ARDecodeOutput(mel.contiguous(), z_mask, stops), None

    def decode_launch(self, enc_out, y_lengths, g, n, *args, **kwargs):
        """The mel that the encode launch decoded -> (mel, z_mask)."""
        return enc_out.mel, enc_out.z_mask

    def decode_launch_predicted(self, enc_out, g, n, *args, **kwargs):
        """-> (mel, z_mask, y_lengths numpy): nothing left to predict."""
        return enc_out.mel, enc_out.z_mask, self.host_lengths(enc_out, n)

    def synthesize_batch(self, id_seqs, noise_scale=0.667, length_scale=1.0, seed=None,
                         denoiser_strength=0.0, batch_index: int = 0, speaker_ids=None,
                         max_decoder_steps=None) -> typing.List[np.ndarray]:
        """Sentences of one text bucket -> int16 audio per sentence.
        ``seed`` an int or one per sentence (the module's mask rule); an
        int also seeds WaveGlow's prior with ``batch_index``.
        ``max_decoder_steps`` an int or one per sentence."""
        n = len(id_seqs)
        with trace.span("engine.batch", id=next(self._calls), rows=n) as span:
            enc_out, _ = self.encode_launch(id_seqs, seed=seed,
                                            max_decoder_steps=max_decoder_steps)
            y_lengths = self.host_lengths(enc_out, n)
            parts = self.vocode_launch(
                enc_out.mel, enc_out.z_mask, n, denoiser_strength, y_lengths=y_lengths,
                seed=seed if np.ndim(seed) == 0 else None, batch_index=batch_index)
            b_rows = enc_out.mel.shape[0]
            span.set(bucket=b_rows)
            return self.crop_rows(self.vocode_collect(parts, b_rows), y_lengths, n,
                                  denoiser_strength)
