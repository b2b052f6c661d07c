"""The synthesis engine: staged, bucketed, batched inference on one device.

Counterpart of the single-device HiFi-GAN, WaveGlow and Griffin-Lim batch
paths of ``larynx_tpu/runtime/engine.py``, and of its mel-only ``"none"``
kind behind ``GlowTextToSpeech.phonemes_to_mels``:

  stage A  encode      ids [B,T]        -> means / durations / y_lengths
  stage B  decode      means [B,T]      -> mel [B,M,C]        (flow reverse)
  stage C  vocode      mel [B,M,C]      -> int16 audio [B,M*up]

Between A and B the host needs the mel bucket M.  ``encode_launch`` starts
the copy of the per-sentence mel lengths to pinned host memory and returns
at once (:class:`HostCopy`); ``decode_launch_predicted`` launches the decode
on a bucket predicted from a learned frames-per-token bound and reads the
lengths while it runs, decoding again at the exact bucket if the
prediction was short.  Stage C runs length-sorted ragged row groups, each
at its own bucketed width, with the same group plan as the JAX engine, then the
optional bias denoiser and int16 peak normalisation on the device.
WaveGlow's prior is drawn once for the whole batch, zeroed past each row's
valid blocks and sliced per group, as there.  Griffin-Lim vocodes the
whole batch in one call (60 iterations, Fast Griffin-Lim momentum 0.99 by
default, ``LARYNX_TPU_GL_MOMENTUM`` overrides), in float32 whatever the
vocoder precision, from a random phase drawn on the vocoder's noise stream.

Each vocoded part starts its own copy to pinned host memory, and
``vocode_collect`` waits on the parts' events only, so a caller can launch
the next batch before it collects this one (``_run_jobs``), and units of
several voices that share a vocoder can vocode as one batch
(:func:`_pool_rows`).

``synthesize_stream`` vocodes one utterance in haloed mel windows at fixed
gain (HiFi-GAN only); ``decode_launch(row_seeds=...)`` draws each seeded
row's latent noise from its own seed, which lets the batch scheduler
(``runtime/scheduler.py``) put seeded requests in one batch.  A
multi-speaker voice takes ``speaker_ids`` at the encode, and their
normalised embeddings ``g`` condition the encode and the decode.

On a serving mesh (``mesh=ServingMesh(...)``, ``parallel/mesh.py``) the
engine keeps a replica of its params (packed kernel weights included) on
each device, rounds the batch bucket up to a multiple of the mesh's size
and runs each position's rows on its device from this one thread
(:class:`RowShards`): the encode and decode of a position's rows, and the
vocode in uniform row groups split over the positions, as the JAX engine's
``shard_map``.  The decode noise (and WaveGlow's prior, and Griffin-Lim's
phase) is drawn once for the whole batch on the first position, at the
single-device engine's batch rows, then sliced and copied, so the mesh
gives the single-device engine's mel.  A single valid row at least
``LARYNX_TPU_TIME_SHARD_MIN_FRAMES`` (default 2 x N x halo) wide is
vocoded along time over every position, and 1 < n_valid < N rows on the
rows x time grid of ``_grid_vocode_plan`` (``parallel/time_shard.py``),
as there.  The stream, and ``phonemes_to_mels``, run on the first position
alone (JAX computes the same values on every position).

A Tacotron2 voice builds :class:`Tacotron2Engine`
(``runtime/tacotron2_engine.py``): its encode launch runs the encode, the
autoregressive decode of the batch's rows and the postnet, and hands the mel
and the stop lengths to the same staged calls and vocode path.

On a CUDA device GlowTTS's encode and flow decode replay CUDA graphs, one
per bucket key (:class:`GlowGraphs`, ``runtime/glow_graphs.py``): their
~1280 small kernels a batch of 8 run faster than the host can launch
them one by one.  Shapes beyond the bucket grid, and the mesh's stages, run
eagerly, as does every stage on the CPU.  In float32 on CUDA the flow's
WaveNet layers run one kernel launch each (``ops/flow_wn.py``), on weights
packed here at load (``models/glow_tts/model.py::pack_params``).

Precision, as in the JAX engine: ``half`` runs GlowTTS and the vocoder in
bfloat16, ``vocoder_half`` the vocoder alone; by default the vocoder is
bfloat16 on a CUDA device and float32 on the CPU (:func:`default_vocoder_half`).
The mel is cast to the vocoder's dtype after post-processing, as is
WaveGlow's prior, and the audio returns to float32 before the denoiser and
int16.
"""

import itertools
import logging
import math
import os
import threading
import time
import typing

import numpy as np
import torch

import larynx_tpu_torch.dsp.mel as dspmel
import larynx_tpu_torch.dsp.stft as dsp
from larynx_tpu_torch.audio import AudioSettings
from larynx_tpu_torch.audio import mel_basis as make_mel_basis
from larynx_tpu_torch.device import host_tensor, resolve_device, to_device
from larynx_tpu_torch.models.glow_tts import model as glow_model
from larynx_tpu_torch.models.glow_tts.config import GlowTTSConfig
from larynx_tpu_torch.models.hifi_gan import denoiser as hifi_denoiser
from larynx_tpu_torch.models.hifi_gan import model as hifi_model
from larynx_tpu_torch.models.hifi_gan.config import HiFiGanConfig
from larynx_tpu_torch.models.tacotron2.config import Tacotron2Config
from larynx_tpu_torch.models.waveglow import model as wg_model
from larynx_tpu_torch.models.waveglow.config import WaveGlowConfig
from larynx_tpu_torch.ops.mrf_block import chain_halo
from larynx_tpu_torch.runtime import trace
from larynx_tpu_torch.runtime.buckets import BucketPolicy
from larynx_tpu_torch.runtime.glow_graphs import GlowGraphs
from larynx_tpu_torch.weights import cast, tree_to

_LOGGER = logging.getLogger("larynx_tpu_torch.engine")

SILENCE_LOG_MEL = float(np.log(1e-5))

# Group-plan constants of the JAX engine's defaults: upper bound on
# (rows x mel frames) per vocoder call (LARYNX_TPU_MAX_VOCODE_AREA, read at
# import as there), and the estimated int16 bytes below which a plan neither
# ramps its first group nor splits a small batch.  Kept equal so every row
# is vocoded at the same width as there.
MAX_VOCODE_AREA = int(os.environ.get("LARYNX_TPU_MAX_VOCODE_AREA", "16384"))
RAMP_MIN_BYTES = 8_000_000

# Mel frames per independently seeded block of per-row noise (row_noise).
NOISE_BLOCK_FRAMES = 256

# Safety margin of the predicted mel bucket over the learned frames-per-token
# bound (the JAX engine's).
BUCKET_MARGIN = 1.15


def _env_flag(name: str, default: str) -> bool:
    return os.environ.get(name, default).lower() not in ("0", "false", "no")


def vocode_pool_enabled() -> bool:
    """Units of a document that share a vocoder vocode as one pooled batch
    (``_run_jobs``), as in the JAX engine; ``LARYNX_TPU_VOCODE_POOL=0``
    vocodes each unit alone.  Read at each call."""
    return _env_flag("LARYNX_TPU_VOCODE_POOL", "1")


def fused_encode_enabled() -> bool:
    """``encode_decode_launch_predicted``'s gate, off by default as in the
    JAX engine (``LARYNX_TPU_FUSED_ENCODE=1`` turns it on).  Read at each
    call."""
    return _env_flag("LARYNX_TPU_FUSED_ENCODE", "0")


def _pool_rows(mels, masks, n_valids, m_pool: int):
    """The first ``n_valids[i]`` rows of each (mel [B, M, C], mask [B, M])
    pair, their frames zero-padded to ``m_pool``, concatenated.  The padded
    frames carry a zero mask, so a pooled row is vocoded as at its own
    unit's width (``larynx_tpu/runtime/engine.py::_pool_rows``)."""
    out_mel, out_mask = [], []
    for mel, mask, n in zip(mels, masks, n_valids):
        pad = m_pool - mel.shape[1]
        out_mel.append(torch.nn.functional.pad(mel[:n], (0, 0, 0, pad)))
        out_mask.append(torch.nn.functional.pad(mask[:n], (0, pad)))
    return torch.cat(out_mel), torch.cat(out_mask)


class HostCopy:
    """A tensor's copy to the host, started without blocking: on CUDA into a
    pinned host tensor by ``copy_(non_blocking=True)`` on the tensor's
    current stream, with an event recorded behind it (the JAX engine's
    ``_start_d2h``).  :meth:`numpy` waits on that event alone and returns
    pageable memory, so the pinned block goes back to the allocator's
    cache for the next copy.  A CPU tensor has nothing to wait for."""

    def __init__(self, src: torch.Tensor):
        self.shape = tuple(src.shape)
        self._event = None
        if src.device.type == "cuda":
            self._host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            self._host.copy_(src, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(src.device))
        else:
            self._host = src

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy().copy()


class EncodeOutput(tuple):
    """``encode``'s (x_m, x_logs, logw, w_ceil, y_lengths, x_mask); its
    ``lengths`` is the copy of y_lengths to the host, started at the launch.
    It travels with the output, not on the engine: the threads that share
    an engine each read their own."""

    def __new__(cls, tensors):
        out = super().__new__(cls, tensors)
        out.lengths = HostCopy(tensors[4])
        return out


class RowShards:
    """A batch split by rows over a serving mesh's positions: shard k holds
    rows ``[k * s, (k + 1) * s)`` on position k's device."""

    def __init__(self, shards: typing.Sequence[torch.Tensor]):
        self.shards = list(shards)

    @property
    def shape(self) -> typing.Tuple[int, ...]:
        first = self.shards[0]
        return (first.shape[0] * len(self.shards),) + tuple(first.shape[1:])

    def rows(self, start: int, stop: int, device) -> torch.Tensor:
        """Rows [start, stop) on ``device``, copied without blocking from
        the shards that hold them."""
        s = self.shards[0].shape[0]
        pieces = []
        for k in range(start // s, -(-stop // s)):
            lo, hi = max(start, k * s) - k * s, min(stop, (k + 1) * s) - k * s
            pieces.append(self.shards[k][lo:hi].to(device, non_blocking=True))
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


class _HostCopies:
    """Several positions' copies of one batch's rows, joined on the host."""

    def __init__(self, copies: typing.Sequence[HostCopy]):
        self._copies = list(copies)

    def numpy(self) -> np.ndarray:
        return np.concatenate([c.numpy() for c in self._copies])


class MeshEncodeOutput(tuple):
    """``encode``'s six outputs as :class:`RowShards` over a mesh; its
    ``lengths`` is every position's copy of y_lengths to the host."""

    def __new__(cls, per_position):
        out = super().__new__(cls, [RowShards(t) for t in zip(*per_position)])
        out.lengths = _HostCopies([HostCopy(o[4]) for o in per_position])
        return out


def default_vocoder_half(device=None) -> bool:
    """The vocoder's default precision, the JAX engine's contract
    (``larynx_tpu/runtime/engine.py::default_vocoder_half``) with "TPU
    backend" read as "CUDA device": bfloat16 on CUDA (the dense bf16
    tensor-core rate and half the bytes; the tanh-bounded waveform is
    audibly identical), float32 elsewhere.  ``device`` None means the
    default device (CUDA when present).
    ``LARYNX_TPU_VOCODER_PRECISION={bf16,f32}`` overrides."""
    pref = os.environ.get("LARYNX_TPU_VOCODER_PRECISION", "").lower()
    if pref in ("bf16", "bfloat16", "half"):
        return True
    if pref in ("f32", "float32", "full"):
        return False
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


# Copied from larynx_tpu/runtime/engine.py::stream_halo_frames.
def stream_halo_frames(voc_cfg: HiFiGanConfig) -> int:
    """Mel-frame halo outside which a vocoded sample cannot depend on a
    chunk boundary: walk the receptive field backward through conv_post,
    each stage's MRF section and transposed conv, and conv_pre.  Chunked
    vocoding with this halo is bit-identical to the full run."""
    h = 3  # conv_post 'same' halo, samples at the last stage's rate
    for i in reversed(range(len(voc_cfg.upsample_rates))):
        u = voc_cfg.upsample_rates[i]
        k = voc_cfg.upsample_kernel_sizes[i]
        h += max(
            chain_halo(kk, dd, 2 if voc_cfg.resblock == "1" else 1)
            for kk, dd in zip(voc_cfg.resblock_kernel_sizes, voc_cfg.resblock_dilation_sizes)
        )
        pad = (k - u) // 2
        h = -(-(h + (k - 1 - pad)) // u)  # transposed-conv back-map
    return h + 3  # conv_pre halo (k=7, 'same') in mel frames


def ola_gain(fft: int, hop: int) -> float:
    """The denoiser's un-normalised Hann^2 overlap-add multiplies the
    waveform by sum(w^2) / hop (~1.4985 at 1024/256); the batch path absorbs
    it in its per-row peak normalisation, the fixed-gain stream divides it
    out."""
    return float(np.sum(dsp.hann_window(fft) ** 2) / hop)


def waveglow_area() -> int:
    """(rows x mel frames) bound per WaveGlow vocoder call: a quarter of
    MAX_VOCODE_AREA, as the JAX engine's default (its WN stack keeps
    several [blocks, 2 * wn_channels] buffers live per row)."""
    return max(64, MAX_VOCODE_AREA // 4)


def postprocess(mel: torch.Tensor, z_mask: torch.Tensor, settings: AudioSettings):
    """[B, M, C] mel -> [B, C, M] denormalised, silence in padded frames."""
    mel_pp = dspmel.mel_postprocess(mel.float().transpose(1, 2), settings)
    return torch.where(z_mask[:, None, :] > 0, mel_pp, SILENCE_LOG_MEL)


def to_int16(audio: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Peak-normalise over each row's valid samples (floor 0.01), clip to
    +-32767 and truncate toward zero."""
    t = audio.shape[-1]
    sample_mask = torch.arange(t, device=audio.device)[None, :] < n_valid[:, None]
    masked = torch.where(sample_mask, audio.abs(), 0.0)
    peak = torch.clamp(masked.amax(dim=-1, keepdim=True), min=0.01)
    scaled = torch.clamp(audio * (32767.0 / peak), -32767.0, 32767.0)
    return scaled.to(torch.int16)


class SynthesisEngine:
    """Parameters and staged inference for one (GlowTTS voice, vocoder) pair;
    the vocoder is HiFi-GAN, WaveGlow or Griffin-Lim, or none (mels only).
    Built from a ``Tacotron2Config``, the engine is a :class:`Tacotron2Engine`.

    ``half`` casts both models to bfloat16; ``vocoder_half`` (None: ``half``
    or :func:`default_vocoder_half` on the engine's device) the vocoder.
    ``dtype`` and ``voc_dtype`` are the resulting compute dtypes."""

    autoregressive = False  # the output length is known only once the model has run

    def __new__(cls, glow_params=None, glow_cfg=None, *args, **kwargs):
        if cls is SynthesisEngine and isinstance(glow_cfg, Tacotron2Config):
            from larynx_tpu_torch.runtime.tacotron2_engine import Tacotron2Engine

            cls = Tacotron2Engine
        return super().__new__(cls)

    def __init__(
        self,
        glow_params,
        glow_cfg: GlowTTSConfig,
        audio_settings: AudioSettings,
        vocoder_kind: str = "hifi_gan",
        vocoder_params=None,
        vocoder_cfg: typing.Union[HiFiGanConfig, WaveGlowConfig, None] = None,
        policy: typing.Optional[BucketPolicy] = None,
        seed: int = 1234,
        waveglow_sigma: float = 0.9,
        device=None,
        half: bool = False,
        vocoder_half: typing.Optional[bool] = None,
        griffin_lim_iters: int = 60,
        griffin_lim_momentum: typing.Optional[float] = None,
        mesh=None,
    ):
        if vocoder_kind not in ("hifi_gan", "waveglow", "griffin_lim", "none"):
            raise ValueError(f"unknown vocoder kind {vocoder_kind!r}")
        neural = vocoder_kind in ("hifi_gan", "waveglow")
        if neural and (vocoder_cfg is None or vocoder_params is None):
            raise ValueError(f"the {vocoder_kind} engine needs vocoder params and config")
        if self.autoregressive and mesh is not None:
            raise ValueError("an autoregressive voice runs on one device: pass no mesh")
        # the serving mesh (parallel/mesh.py::ServingMesh): rows over its
        # positions; None is one device.  Its first position is the
        # engine's device.
        self.mesh = mesh
        self._n_data = len(mesh) if mesh is not None else 1
        self.device = resolve_device(mesh.positions[0] if mesh is not None else device)
        self.glow_cfg = glow_cfg
        self.audio_settings = audio_settings
        self.vocoder_kind = vocoder_kind
        self.vocoder_cfg = vocoder_cfg
        # an autoregressive decode emits one frame a step
        self.policy = policy or BucketPolicy(n_sqz=1 if self.autoregressive else glow_cfg.n_sqz)
        self.seed = seed
        self.waveglow_sigma = waveglow_sigma
        self.half = half
        self.vocoder_half = (
            vocoder_half if vocoder_half is not None
            else (half or default_vocoder_half(self.device))
        )
        # Tacotron2 runs in float32 whatever ``half``, as its voice does
        self.dtype = torch.bfloat16 if half and not self.autoregressive else torch.float32
        self.voc_dtype = torch.bfloat16 if self.vocoder_half else torch.float32
        self.glow_params = cast(tree_to(glow_params, self.device), self.dtype)
        if self.device.type == "cuda" and not self.autoregressive:
            # the flow WaveNets' kernel weights (float32 only), once
            self.glow_params = glow_model.pack_params(self.glow_params)
        # GlowTTS's encode and flow decode as CUDA graphs per bucket key
        self._glow_graphs = (GlowGraphs(self.glow_params, glow_cfg, self.policy, self.device)
                             if self.device.type == "cuda" and not self.autoregressive else None)
        self.griffin_lim_iters = griffin_lim_iters
        if griffin_lim_momentum is None:
            griffin_lim_momentum = float(os.environ.get("LARYNX_TPU_GL_MOMENTUM", "0.99"))
        self.griffin_lim_momentum = griffin_lim_momentum
        self.vocoder_params = None
        if vocoder_kind == "hifi_gan":
            pack = hifi_model.pack_params
            self.upsample, self.num_mels = vocoder_cfg.total_upsample, vocoder_cfg.num_mels
        elif vocoder_kind == "waveglow":
            pack = wg_model.pack_params
            self.upsample, self.num_mels = vocoder_cfg.upsample_stride, vocoder_cfg.mel_channels
        else:
            self.upsample, self.num_mels = audio_settings.hop_length, audio_settings.mel_channels
        if neural:
            self.vocoder_params = pack(
                cast(tree_to(vocoder_params, self.device), self.voc_dtype), vocoder_cfg
            )
        if vocoder_kind == "griffin_lim":
            self._gl_basis = torch.from_numpy(make_mel_basis(
                audio_settings.sample_rate, audio_settings.filter_length,
                audio_settings.mel_channels, audio_settings.mel_fmin, audio_settings.mel_fmax,
            )).to(self.device)
        self._bias_spec = None  # lazy denoiser bias, built once under _bias_lock
        self._bias_lock = threading.Lock()
        self.generator_calls = 0  # vocoder runs (generator or WaveGlow infer), bias included
        self._calls = itertools.count()  # synthesize_batch / stream calls: their spans' id
        # the predicted mel bucket's state: an upper bound on mel frames per
        # input token at length scale 1 (0: nothing observed yet), and the
        # decodes launched again because a prediction fell short
        self._frames_per_token = 0.0
        self._bucket_mispredicts = 0
        # the mesh's routes: single-row time shards and rows x time grids
        # taken (the tests pin that the gates route as JAX's), and the grid
        # programs, built on first use per (n_rows, n_time)
        self._time_shard_hits = 0
        self._grid_shard_hits = 0
        self._grid_fns: typing.Dict[typing.Tuple[int, int], typing.Any] = {}
        # per device: (glow params, vocoder params, Griffin-Lim basis)
        self._replicas = {self.device: (self.glow_params, self.vocoder_params,
                                        getattr(self, "_gl_basis", None))}
        if mesh is not None:
            for dev in mesh.devices:
                dev = resolve_device(dev)
                if dev not in self._replicas:
                    self._replicas[dev] = (
                        tree_to(self.glow_params, dev),
                        None if self.vocoder_params is None
                        else pack(cast(tree_to(vocoder_params, dev), self.voc_dtype), vocoder_cfg),
                        None if vocoder_kind != "griffin_lim" else self._gl_basis.to(dev),
                    )
        self._bias_on: typing.Dict[torch.device, torch.Tensor] = {}
        if vocoder_kind == "hifi_gan":
            self._ts_halo = stream_halo_frames(vocoder_cfg)
        elif vocoder_kind == "waveglow":
            from larynx_tpu_torch.parallel.time_shard import waveglow_halo_frames

            self._wg_halo_frames = waveglow_halo_frames(vocoder_cfg)

    @property
    def _time_shard_min_frames(self) -> int:
        """The shortest mel bucket that a single valid row time-shards at:
        ``LARYNX_TPU_TIME_SHARD_MIN_FRAMES``, read at each call, else 2 x N x
        halo, where the latency model predicts a speed-up of N / 2 (the JAX
        engine's gate)."""
        return int(os.environ.get("LARYNX_TPU_TIME_SHARD_MIN_FRAMES",
                                  2 * self._n_data * self._ts_halo))

    # ------------------------------------------------------------------
    # helpers

    @staticmethod
    def _row_values(value, b_bucket: int) -> np.ndarray:
        """Scalar or per-row sequence -> [b_bucket] f32, padding rows
        filled with the last given value."""
        arr = np.empty((b_bucket,), dtype=np.float32)
        if np.ndim(value) == 0:
            arr[:] = float(value)
        else:
            value = np.asarray(value, dtype=np.float32)
            arr[: len(value)] = value
            arr[len(value):] = value[-1] if len(value) else 0.0
        return arr

    def _row_param(self, value, b_bucket: int, ndim: int, device=None) -> torch.Tensor:
        """Scalar or per-row sequence -> [b_bucket, 1, ...] f32 tensor on
        ``device`` (default the engine's)."""
        arr = self._row_values(value, b_bucket).reshape((b_bucket,) + (1,) * (ndim - 1))
        return to_device(arr, self.device if device is None else device)

    def _generator(self, entropy: typing.List[int]) -> torch.Generator:
        """A generator on the engine's device seeded by ``SeedSequence(entropy)``."""
        state = np.random.SeedSequence(entropy).generate_state(1)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(state[0]))
        return gen

    def _noise_generator(self, seed: typing.Optional[int], batch_index: int, stream: int = 0):
        """A generator seeded from (seed or the engine's seed, batch index);
        stream 0 is the decode noise, stream 1 the vocoder's (WaveGlow's prior
        or Griffin-Lim's initial phase)."""
        base = self.seed if seed is None else seed
        return self._generator([base & 0xFFFFFFFF, batch_index] + ([stream] if stream else []))

    def row_noise(self, row_seeds, b: int, m: int, c: int, batch_index: int) -> torch.Tensor:
        """Per-row standard-normal latent noise [b, m, c]: a seeded row's
        comes only from its seed, an unseeded row's (padding rows included)
        from (engine seed, batch index, row).  Each row is drawn in blocks
        of NOISE_BLOCK_FRAMES frames, block j from its own generator on
        (row entropy, j): every block has one shape, so frame f's values
        depend only on (row entropy, f) and a wider mel bucket extends a
        row's noise without changing its prefix."""
        rows = []
        for r in range(b):
            s = row_seeds[r] if r < len(row_seeds) else None
            if s is None:
                entropy = [self.seed & 0xFFFFFFFF, batch_index, r, 1]
            else:
                entropy = [int(s) & 0xFFFFFFFF, 0]
            blocks = [
                torch.randn((NOISE_BLOCK_FRAMES, c), generator=self._generator(entropy + [j]),
                            device=self.device)
                for j in range(-(-m // NOISE_BLOCK_FRAMES))
            ]
            rows.append(torch.cat(blocks)[:m])
        return torch.stack(rows)

    def _generate(self, mel: torch.Tensor, z: typing.Optional[torch.Tensor] = None,
                  params=None) -> torch.Tensor:
        """mel [B, M, C] -> float32 audio [B, M * upsample]; ``z`` is
        WaveGlow's prior [B, blocks, groups].  Both are cast to the
        vocoder's dtype.  ``params``: a mesh position's vocoder replica
        (default the engine's)."""
        self.generator_calls += 1
        params = self.vocoder_params if params is None else params
        mel = mel.to(self.voc_dtype)
        if self.vocoder_kind == "waveglow":
            z = None if z is None else z.to(self.voc_dtype)
            return wg_model.infer(params, self.vocoder_cfg, mel, z=z).float()
        return hifi_model.generator(params, self.vocoder_cfg, mel).float()

    # ------------------------------------------------------------------
    # stages

    def _pad_id_arrays(self, id_seqs, n_data: int = 1):
        """Pad id sequences to (text, batch) buckets, the batch bucket
        rounded up to a multiple of ``n_data``; pad rows get length 1 ->
        (ids, lengths, b_bucket) on the host."""
        n = len(id_seqs)
        t_bucket = self.policy.text_bucket(max(len(s) for s in id_seqs))
        b_bucket = -(-self.policy.batch_bucket(n) // n_data) * n_data
        ids = np.zeros((b_bucket, t_bucket), dtype=np.int64)
        lengths = np.zeros((b_bucket,), dtype=np.int64)
        for i, seq in enumerate(id_seqs):
            ids[i, : len(seq)] = seq
            lengths[i] = len(seq)
        lengths[n:] = 1
        return ids, lengths, b_bucket

    def _speaker_index(self, speaker_ids, b_bucket: int) -> typing.Optional[np.ndarray]:
        """Speaker indices [b_bucket] (padding rows take speaker 0), or None
        for a single-speaker voice.  A multi-speaker voice without speaker
        ids raises: its duration predictor and couplings take the
        embedding."""
        if "emb_g" not in self.glow_params:
            return None
        n_speakers = self.glow_params["emb_g"].shape[0]
        if speaker_ids is None:
            raise ValueError(
                f"this GlowTTS voice has {n_speakers} speakers: pass speaker_ids "
                "(speaker_id for one sentence); there is no default speaker"
            )
        idx = np.zeros((b_bucket,), dtype=np.int64)
        idx[: len(speaker_ids)] = np.asarray(speaker_ids, dtype=np.int64)
        if idx.min() < 0 or idx.max() >= n_speakers:
            raise ValueError(f"speaker ids {list(speaker_ids)} outside [0, {n_speakers})")
        return idx

    def _speaker_embedding(self, speaker_ids, b_bucket: int):
        """Speaker indices -> normalised embeddings [b_bucket, gin] on the
        engine's device, or None for a single-speaker voice."""
        idx = self._speaker_index(speaker_ids, b_bucket)
        if idx is None:
            return None
        return glow_model.speaker_embedding(self.glow_params, to_device(idx, self.device))

    @torch.inference_mode()
    def encode_launch(self, id_seqs, length_scale=1.0, speaker_ids=None, seed=None,
                      max_decoder_steps=None):
        """Encode a batch -> (:class:`EncodeOutput`, g), without waiting for
        the card: the output's ``lengths`` is the copy of y_lengths to the
        host, already started.  ``g`` is the speaker conditioning of
        ``speaker_ids`` (one per sentence), None for a single-speaker voice.
        On a mesh: (:class:`MeshEncodeOutput`, g as :class:`RowShards`).
        ``seed`` and ``max_decoder_steps`` are an autoregressive voice's,
        whose decode runs inside its encode launch (:class:`Tacotron2Engine`);
        GlowTTS draws its noise at the decode and takes neither."""
        if self.mesh is not None:
            return self._mesh_encode(id_seqs, length_scale, speaker_ids)
        return self._encode_one(id_seqs, length_scale, speaker_ids)

    def _mesh_encode(self, id_seqs, length_scale, speaker_ids):
        """Each position encodes its rows of the batch, on its device."""
        with trace.span("engine.pad"):
            ids, lengths, b_bucket = self._pad_id_arrays(id_seqs, self._n_data)
            idx = self._speaker_index(speaker_ids, b_bucket)
            scales = self._row_values(length_scale, b_bucket)
        s = b_bucket // self._n_data
        outs, gs = [], []
        with trace.span("engine.encode", rows=b_bucket, text_bucket=ids.shape[1]):
            if self._glow_graphs is not None:
                self._glow_graphs.eager()
            for k, dev in enumerate(self.mesh.positions):
                rows = slice(k * s, (k + 1) * s)
                glow = self._replicas[dev][0]
                g = None if idx is None else glow_model.speaker_embedding(
                    glow, to_device(idx[rows], dev))
                outs.append(glow_model.encode(
                    glow, self.glow_cfg, to_device(ids[rows], dev), to_device(lengths[rows], dev),
                    length_scale=to_device(scales[rows].reshape(s, 1), dev), g=g,
                ))
                gs.append(g)
            return MeshEncodeOutput(outs), (None if idx is None else RowShards(gs))

    def _encode_one(self, id_seqs, length_scale=1.0, speaker_ids=None):
        """:meth:`encode_launch` on the engine's device alone: a graph's
        replay where :class:`GlowGraphs` takes the shape, else eagerly."""
        graphs = self._glow_graphs
        with trace.span("engine.pad"):
            ids, lengths, b_bucket = self._pad_id_arrays(id_seqs)
            graphed = graphs is not None and graphs.encodes(*ids.shape)
            if graphed:
                scales = self._row_values(length_scale, b_bucket).reshape(b_bucket, 1)
                host = [host_tensor(a, self.device) for a in (ids, lengths, scales)]
            else:
                ids, lengths = to_device(ids, self.device), to_device(lengths, self.device)
        with trace.span("engine.encode", rows=b_bucket, text_bucket=ids.shape[1]):
            g = self._speaker_embedding(speaker_ids, b_bucket)
            if graphed:
                return EncodeOutput(graphs.encode(*host, g)), g
            if graphs is not None:
                graphs.eager()
            out = glow_model.encode(
                self.glow_params, self.glow_cfg, ids, lengths,
                length_scale=self._row_param(length_scale, b_bucket, 2), g=g,
            )
            return EncodeOutput(out), g

    def encode_batch(self, id_seqs, length_scale=1.0, speaker_ids=None):
        """Blocking encode -> (outputs, y_lengths numpy, g)."""
        out, g = self.encode_launch(id_seqs, length_scale, speaker_ids=speaker_ids)
        return out, self.host_lengths(out, len(id_seqs)), g

    @staticmethod
    def host_lengths(enc_out, n: int) -> np.ndarray:
        """Wait for the copy of an encode's y_lengths -> numpy; counts the
        ``n`` valid rows' frames in ``engine.valid_frames``, once per batch
        decoded."""
        with trace.span("engine.lengths_wait"):
            y_lengths = enc_out.lengths.numpy()
        trace.count("engine.valid_frames", int(np.sum(y_lengths[:n])))
        return y_lengths

    @torch.inference_mode()
    def decode_launch(
        self,
        enc_out,
        y_lengths: typing.Optional[np.ndarray],
        g,
        n: int,
        noise_scale=0.667,
        seed: typing.Optional[int] = None,
        batch_index: int = 0,
        row_seeds: typing.Optional[typing.Sequence[typing.Optional[int]]] = None,
        mel_bucket_override: typing.Optional[int] = None,
        redo: bool = False,
    ):
        """Flow decode at ``policy.mel_bucket(max y_length)``, or at
        ``mel_bucket_override`` (then ``y_lengths`` may be None: the rows'
        masks come from the lengths on the device) -> (mel, z_mask).

        ``row_seeds`` (one entry per sentence, None = unseeded) switches to
        per-row noise (:meth:`row_noise`), so seeded rows reproduce whatever
        their batchmates; it replaces the scalar ``seed``.  ``redo`` marks
        the decode again of a prediction that fell short, in its span."""
        x_m, x_logs, _logw, w_ceil, y_dev, _mask = enc_out
        b, t, c = x_m.shape
        mel_bucket = (
            mel_bucket_override if mel_bucket_override is not None
            else self.policy.mel_bucket(int(y_lengths[:n].max()))
        )
        trace.count("engine.decode_frames", b * mel_bucket)
        graphs = self._glow_graphs
        with trace.span("engine.decode", rows=b, mel_bucket=mel_bucket, redo=redo):
            if isinstance(enc_out, MeshEncodeOutput):
                if graphs is not None:
                    graphs.eager()
                return self._mesh_decode(enc_out, g, n, mel_bucket, noise_scale, seed,
                                         batch_index, row_seeds)
            noise = generator = None
            if row_seeds is not None:
                noise = self.row_noise(row_seeds, b, mel_bucket, c, batch_index)
            else:
                generator = self._noise_generator(seed, batch_index)
            if graphs is not None and graphs.decodes(b, t, mel_bucket):
                scales = self._row_values(noise_scale, b).reshape(b, 1, 1)
                return graphs.decode(x_m, x_logs, w_ceil, y_dev, g, mel_bucket,
                                     host_tensor(scales, self.device), noise, generator)
            if graphs is not None:
                graphs.eager()
            return glow_model.expand_and_decode(
                self.glow_params, self.glow_cfg, x_m, x_logs, w_ceil, y_dev,
                mel_max_length=mel_bucket,
                noise_scale=self._row_param(noise_scale, b, 3),
                noise=noise,
                generator=generator,
                g=g,
            )

    def _mesh_decode(self, enc_out, g, n, mel_bucket, noise_scale, seed, batch_index, row_seeds):
        """Each position decodes its rows.  The noise is drawn once on the
        first position, as the single-device engine draws it (its batch
        bucket of n rows; the mesh's extra padding rows take zeros), then
        sliced and copied: the mesh gives the single-device mel."""
        x_m, x_logs, _logw, w_ceil, y_dev, _mask = enc_out
        b, _t, c = x_m.shape
        if row_seeds is not None:
            noise = self.row_noise(row_seeds, b, mel_bucket, c, batch_index)
        else:
            noise = torch.randn((self.policy.batch_bucket(n), mel_bucket, c),
                                generator=self._noise_generator(seed, batch_index),
                                device=self.device, dtype=self.dtype)
            noise = torch.nn.functional.pad(noise, (0, 0, 0, 0, 0, b - noise.shape[0]))
        scales = self._row_values(noise_scale, b)
        s = b // self._n_data
        mels, masks = [], []
        for k, dev in enumerate(self.mesh.positions):
            rows = slice(k * s, (k + 1) * s)
            mel, z_mask = glow_model.expand_and_decode(
                self._replicas[dev][0], self.glow_cfg, x_m.shards[k], x_logs.shards[k],
                w_ceil.shards[k], y_dev.shards[k], mel_max_length=mel_bucket,
                noise_scale=to_device(scales[rows].reshape(s, 1, 1), dev),
                noise=noise[rows].to(dev, non_blocking=True),
                g=None if g is None else g.shards[k],
            )
            mels.append(mel)
            masks.append(z_mask)
        return RowShards(mels), RowShards(masks)

    # ------------------------------------------------------------------
    # the predicted mel bucket

    @staticmethod
    def _length_scale_max(length_scale) -> float:
        """The largest per-row length scale, floored away from zero: the
        estimator counts frames per token at length scale 1, so a request's
        scale divides out of an observation and multiplies into a prediction."""
        try:
            ls = float(max(length_scale))
        except TypeError:
            ls = float(length_scale)
        return max(ls, 1e-6)

    def _predict_mel_bucket(self, max_id_len: int, ls: float) -> int:
        """The mel bucket of the learned frames-per-token bound, plus 15%."""
        pred_frames = int(math.ceil(max_id_len * self._frames_per_token * ls * BUCKET_MARGIN))
        return self.policy.mel_bucket(pred_frames)

    def _observe_frames_per_token(self, actual: int, max_id_len: int, ls: float) -> None:
        """Jump to a new maximum at once (an upper bound); decay slowly
        toward smaller observations."""
        if max_id_len <= 0:
            return
        obs = actual / (max_id_len * ls)
        self._frames_per_token = (
            obs if obs > self._frames_per_token
            else 0.99 * self._frames_per_token + 0.01 * obs
        )

    def decode_launch_predicted(
        self,
        enc_out,
        g,
        n: int,
        max_id_len: int,
        noise_scale=0.667,
        length_scale=1.0,
        seed: typing.Optional[int] = None,
        batch_index: int = 0,
        row_seeds: typing.Optional[typing.Sequence[typing.Optional[int]]] = None,
    ):
        """Decode without waiting for the lengths' copy -> (mel, z_mask,
        y_lengths numpy).

        The decode needs only the mel bucket from the host: the rows' masks
        come from the lengths on the device, correct at any bucket at least
        the longest row.  So the bucket is predicted from the learned bound,
        the decode launched, and the lengths read while it runs.  A
        prediction that falls short decodes again at the exact bucket and
        counts in ``_bucket_mispredicts``.  A wider bucket draws other latent
        noise (its shape changes), so explicitly seeded requests (``seed``
        or ``row_seeds``) take the exact bucket, as in the JAX engine."""
        ls = self._length_scale_max(length_scale)
        decoded = None
        bucket = 0
        if self._frames_per_token > 0.0 and max_id_len > 0 and row_seeds is None \
                and seed is None:
            bucket = self._predict_mel_bucket(max_id_len, ls)
            decoded = self.decode_launch(
                enc_out, None, g, n, noise_scale=noise_scale, batch_index=batch_index,
                mel_bucket_override=bucket,
            )
        y_lengths = self.host_lengths(enc_out, n)
        actual = int(y_lengths[:n].max())
        self._observe_frames_per_token(actual, max_id_len, ls)
        if decoded is not None and actual <= bucket:
            mel, z_mask = decoded
        else:
            if decoded is not None:
                self._bucket_mispredicts += 1
            mel, z_mask = self.decode_launch(
                enc_out, y_lengths, g, n, noise_scale=noise_scale, seed=seed,
                batch_index=batch_index, row_seeds=row_seeds, redo=decoded is not None,
            )
        return mel, z_mask, y_lengths

    def encode_decode_launch_predicted(
        self,
        id_seqs,
        length_scale=1.0,
        speaker_ids=None,
        noise_scale=0.667,
        batch_index: int = 0,
    ):
        """Encode, then decode at the predicted bucket with no sync between
        them -> (mel, z_mask, y_lengths numpy, g); None when the gate
        (:func:`fused_encode_enabled`) is off, the estimator has observed
        nothing yet or the batch is empty.  The JAX engine fuses the two
        into one program; eager PyTorch launches them back to back."""
        max_id_len = max((len(s) for s in id_seqs), default=0)
        if (self.mesh is not None or self._frames_per_token <= 0.0 or max_id_len <= 0
                or not fused_encode_enabled()):
            return None
        enc_out, g = self.encode_launch(id_seqs, length_scale, speaker_ids=speaker_ids)
        mel, z_mask, y_lengths = self.decode_launch_predicted(
            enc_out, g, len(id_seqs), max_id_len, noise_scale=noise_scale,
            length_scale=length_scale, batch_index=batch_index,
        )
        return mel, z_mask, y_lengths, g

    @torch.inference_mode()
    def vocode_launch(
        self, mel, z_mask, n_valid: int, denoiser_strength, y_lengths=None,
        seed: typing.Optional[int] = None, batch_index: int = 0,
    ):
        """Vocode the first ``n_valid`` rows -> [(int16 part, row indices)];
        each part is a :class:`HostCopy` whose copy has started.

        ``seed`` and ``batch_index`` seed WaveGlow's prior or Griffin-Lim's
        initial phase, on a stream of their own beside the decode noise's.
        Griffin-Lim vocodes every row in one part and takes no denoiser."""
        if self.vocoder_kind == "none":
            raise RuntimeError("an engine with vocoder_kind='none' cannot vocode "
                               "(mel-only surface; use phonemes_to_mels)")
        with trace.span("engine.vocode", rows=n_valid):
            if isinstance(mel, RowShards):
                return self._mesh_vocode(mel, z_mask, n_valid, denoiser_strength, seed,
                                         batch_index)
            if self.vocoder_kind == "griffin_lim":
                part = self._vocode_griffin_lim(mel, z_mask, seed, batch_index)
                return [(HostCopy(part), list(range(mel.shape[0])))]
            z_full = None
            if self.vocoder_kind == "waveglow":
                z_full = self._waveglow_prior(mel.shape[0], mel.shape[1], z_mask, seed,
                                              batch_index)
            return self._vocode_groups(mel, z_mask, n_valid, denoiser_strength, y_lengths,
                                       z_full)

    def _waveglow_prior(self, b: int, m: int, z_mask, seed, batch_index,
                        drawn: typing.Optional[int] = None) -> torch.Tensor:
        """sigma * N(0, 1) for the whole [b, blocks, groups] batch, zeroed past
        each row's y_length * blocks_per_frame: the padded tail is then
        (near-)silence under any bucket width.  ``drawn`` rows are drawn (the
        single-device engine's batch, on a mesh), the others are zeros."""
        cfg = self.vocoder_cfg
        blocks_full = m * cfg.upsample_stride // cfg.groups
        blocks_per_frame = cfg.upsample_stride // cfg.groups
        z_full = self.waveglow_sigma * torch.randn(
            (b if drawn is None else drawn, blocks_full, cfg.groups), device=self.device,
            generator=self._noise_generator(seed, batch_index, stream=1),
        )
        z_full = torch.nn.functional.pad(z_full, (0, 0, 0, 0, 0, b - z_full.shape[0]))
        valid_blocks = (z_mask > 0).sum(dim=1) * blocks_per_frame
        inside = torch.arange(blocks_full, device=self.device)[None, :] < valid_blocks[:, None]
        return torch.where(inside[..., None], z_full, 0.0)

    def _vocode_griffin_lim(self, mel, z_mask, seed, batch_index,
                            initial_phase: typing.Optional[torch.Tensor] = None) -> torch.Tensor:
        """mel [B, M, C] -> int16 audio [B, (M - 1) * hop + fft]: linear
        magnitudes through the mel basis (last frame dropped), Griffin-Lim
        from a random phase (or ``initial_phase``), each row normalised over
        its (y - 1) * hop + fft samples."""
        trace.count("engine.vocode_frames", mel.shape[0] * mel.shape[1])
        fft, hop = self.audio_settings.filter_length, self.audio_settings.hop_length
        mel_pp = postprocess(mel, z_mask, self.audio_settings)
        basis = self._replicas[mel.device][2] if mel.device in self._replicas else self._gl_basis
        spec = dspmel.linear_from_mel(mel_pp, basis, 1000.0)[:, :, :-1]
        signal = dsp.griffin_lim(
            spec, self._noise_generator(seed, batch_index, stream=1), fft, hop,
            self.griffin_lim_iters, initial_phase=initial_phase,
            momentum=self.griffin_lim_momentum,
        )
        y_len = (z_mask > 0).sum(dim=1)
        return to_int16(signal, torch.clamp(y_len - 1, min=1) * hop + fft)

    def _vocode(self, mel, z_mask, bias_spec, strength, denoise: bool, z=None,
                params=None) -> torch.Tensor:
        """mel [B, M, C] -> int16 audio [B, M * upsample (+ STFT tail)];
        ``params`` a mesh position's vocoder replica.  Traced as
        ``engine.vocode_group``, one row group's launches."""
        trace.count("engine.vocode_frames", mel.shape[0] * mel.shape[1])
        with trace.span("engine.vocode_group", rows=mel.shape[0], width=mel.shape[1]):
            mel_pp = postprocess(mel, z_mask, self.audio_settings)
            audio = self._generate(mel_pp.transpose(1, 2), z, params)
            n_valid = (z_mask > 0).sum(dim=1) * self.upsample
            if denoise:
                fft = self.audio_settings.filter_length
                hop = self.audio_settings.hop_length
                frames = (torch.clamp(n_valid - fft, min=0) + hop - 1) // hop
                # an autoregressive voice's rows are cut to their frames before
                # the STFT, as its fallback's vocoders cut them
                audio = hifi_denoiser.denoise(audio, bias_spec, strength, fft, hop,
                                              n_frames=frames if self.autoregressive else None)
                # denoised length per row: frames(n_valid) * hop + fft
                n_valid = frames * hop + fft
            return to_int16(audio, n_valid)

    def _vocode_groups(self, mel, z_mask, n_valid, denoiser_strength, y_lengths, z_full):
        """Length-sorted ragged row groups, each at its own bucketed width;
        WaveGlow's groups are bounded by the smaller :func:`waveglow_area`
        and take their rows and blocks of the prior ``z_full``."""
        b, m, _ = mel.shape
        area = MAX_VOCODE_AREA if z_full is None else waveglow_area()
        denoise = bool(np.any(np.asarray(denoiser_strength) > 0))
        bias = self._get_bias_spec() if denoise else None
        str_rows = self._row_values(denoiser_strength, b)

        if y_lengths is not None:
            lens = np.asarray(y_lengths)[:n_valid].astype(np.int64)
        else:
            lens = np.full((n_valid,), m, dtype=np.int64)
        order = np.argsort(-lens, kind="stable")
        if np.array_equal(order, np.arange(n_valid)) and n_valid == b:
            mel_s, mask_s, z_s = mel, z_mask, z_full
        else:
            idx = to_device(order, self.device)
            mel_s, mask_s = mel.index_select(0, idx), z_mask.index_select(0, idx)
            z_s = None if z_full is None else z_full.index_select(0, idx)
        sorted_lens = lens[order]

        # denoised rows crop to nf*hop + fft samples, slightly past the
        # y*up valid length: widen the per-group bucket by the STFT tail
        margin = -(-self.audio_settings.filter_length // self.upsample) if denoise else 0
        parts = []
        for start, group, m_g in self._ragged_group_plan(
            sorted_lens, n_valid, m, area, margin=margin
        ):
            rows = order[start : start + group]
            z_g = None
            if z_s is not None:
                blocks_g = m_g * self.vocoder_cfg.upsample_stride // self.vocoder_cfg.groups
                z_g = z_s[start : start + group, :blocks_g]
            part = self._vocode(
                mel_s[start : start + group, :m_g],
                mask_s[start : start + group, :m_g],
                bias,
                self._row_param(str_rows[rows], group, 3),
                denoise,
                z_g,
            )
            parts.append((HostCopy(part), [int(i) for i in rows]))
        return parts

    # ------------------------------------------------------------------
    # the mesh's vocode

    def _bias_on_device(self, device) -> torch.Tensor:
        """The denoiser bias (built once on the first position) on ``device``."""
        bias = self._get_bias_spec()
        if device not in self._bias_on:
            self._bias_on[device] = bias.to(device)
        return self._bias_on[device]

    def _mesh_vocode(self, mel, z_mask, n_valid, denoiser_strength, seed, batch_index):
        """The mesh's routes (``larynx_tpu/runtime/engine.py::
        _vocode_launch_hifi`` and its WaveGlow and Griffin-Lim siblings): one
        long valid row time-shards over every position (HiFi-GAN), fewer
        valid rows than positions take the rows x time grid where
        :meth:`_grid_vocode_plan` finds one, else uniform row groups split
        over the positions (:meth:`_mesh_uniform_groups`)."""
        b, m = mel.shape[0], mel.shape[1]
        b_single = self.policy.batch_bucket(n_valid)  # the rows the single engine draws for
        if self.vocoder_kind == "griffin_lim":
            return self._mesh_griffin_lim(mel, z_mask, n_valid, seed, batch_index, b_single)
        waveglow = self.vocoder_kind == "waveglow"
        area = waveglow_area() if waveglow else MAX_VOCODE_AREA
        denoise = bool(np.any(np.asarray(denoiser_strength) > 0))
        str_rows = self._row_values(denoiser_strength, b)
        z_full = None
        if waveglow:
            z_full = self._waveglow_prior(b, m, z_mask.rows(0, b, self.device), seed, batch_index,
                                          drawn=b_single)
        plan = None
        if not waveglow and n_valid == 1 and m >= self._time_shard_min_frames:
            plan = (1, self._n_data)
            self._time_shard_hits += 1
        elif (1 if waveglow else 2) <= n_valid < self._n_data:
            plan = self._grid_vocode_plan(
                n_valid, m, **({"halo": self._wg_halo_frames, "area": area} if waveglow else {}))
            if plan is not None:
                self._grid_shard_hits += 1
        if plan is not None:
            fn = self._grid_fns.get(plan)
            if fn is None:
                fn = self._grid_fns[plan] = self._build_grid(*plan)
            args = [{dev: rep[1] for dev, rep in self._replicas.items()},
                    mel.rows(0, n_valid, self.device), z_mask.rows(0, n_valid, self.device)]
            if waveglow:
                args.append(z_full[:n_valid])
            out = fn(*args, bias_spec=self._get_bias_spec() if denoise else None,
                     strength=self._row_param(str_rows[:n_valid], n_valid, 3), denoise=denoise)
            return out.parts
        return self._mesh_uniform_groups(b, m, n_valid, area, mel, z_mask, z_full, str_rows,
                                         denoise)

    def _build_grid(self, n_rows: int, n_time: int):
        from larynx_tpu_torch.parallel import time_shard

        if self.vocoder_kind == "waveglow":
            return time_shard.make_waveglow_grid_vocode(
                self.vocoder_cfg, self.audio_settings, self.mesh.positions, n_rows, n_time,
                self._wg_halo_frames, voc_dtype=self.voc_dtype)
        return time_shard.make_grid_sharded_vocode(
            self.vocoder_cfg, self.audio_settings, self.mesh.positions, n_rows, n_time,
            self._ts_halo, voc_dtype=self.voc_dtype)

    def _mesh_uniform_groups(self, b, m, n_valid, area, mel, z_mask, z_full, str_rows, denoise):
        """Uniform-width row groups of a multiple of N rows
        (``larynx_tpu/runtime/engine.py::_mesh_uniform_groups``), each split
        into N equal slices, slice k on position k.  The final group clamps
        to the batch's end (overlapping rows are vocoded again with the same
        result); the area cap is per device, so the group's rows scale by
        N.  A slice of padding rows alone is not vocoded."""
        n = self._n_data
        group = max(1, (area * n) // m)
        group = max(group - group % n, n)
        parts = []
        for start in range(0, b, group):
            if start >= n_valid:
                break
            lo, size = (0, b) if group >= b else (min(start, b - group), group)
            per = size // n
            for k, dev in enumerate(self.mesh.positions):
                r0 = lo + k * per
                if r0 >= n_valid:
                    break
                bias = self._bias_on_device(dev) if denoise else None
                part = self._vocode(
                    mel.rows(r0, r0 + per, dev), z_mask.rows(r0, r0 + per, dev), bias,
                    self._row_param(str_rows[r0 : r0 + per], per, 3, dev), denoise,
                    None if z_full is None else z_full[r0 : r0 + per].to(dev, non_blocking=True),
                    params=self._replicas[dev][1],
                )
                parts.append((HostCopy(part), list(range(r0, r0 + per))))
        return parts

    def _mesh_griffin_lim(self, mel, z_mask, n_valid, seed, batch_index, b_single):
        """Each position's rows through Griffin-Lim on its device, from the
        phase the single-device engine draws for its batch (padding rows past
        it start from zero phase)."""
        b, m = mel.shape[0], mel.shape[1]
        n_freq = self.audio_settings.filter_length // 2 + 1
        phase = 2.0 * math.pi * torch.rand(
            (b_single, n_freq, m - 1), generator=self._noise_generator(seed, batch_index, stream=1),
            device=self.device, dtype=torch.float32)
        phase = torch.nn.functional.pad(phase, (0, 0, 0, 0, 0, b - b_single))
        s = b // self._n_data
        parts = []
        for k, dev in enumerate(self.mesh.positions):
            if k * s >= n_valid:
                break
            part = self._vocode_griffin_lim(
                mel.shards[k], z_mask.shards[k], seed, batch_index,
                initial_phase=phase[k * s : (k + 1) * s].to(dev, non_blocking=True))
            parts.append((HostCopy(part), list(range(k * s, (k + 1) * s))))
        return parts

    def _grid_vocode_plan(
        self,
        n_valid: int,
        m: int,
        halo: typing.Optional[int] = None,
        area: typing.Optional[int] = None,
    ) -> typing.Optional[typing.Tuple[int, int]]:
        """Pick the (n_rows, n_time) vocode grid minimizing per-device
        work ``ceil(n_valid/r) * (m/t + 2*halo)`` frames (the model in
        parallel/time_shard.py), subject to the per-device area cap.

        Returns None when plain row sharding (r == n_data, t == 1, work
        = m) is not beaten — the uniform-group path handles that.  Ties
        prefer more rows (less halo re-compute, same wall time).  Grids
        where an entire row shard would hold only padding are excluded:
        every device must carry at least one real row (padded rows may
        ride along in a shard that also holds real ones).

        ``halo``/``area`` default to the HiFi-GAN values; the WaveGlow
        route passes its own (receptive field ~100 frames, quarter area
        cap), which makes the plan decline except at long mels.
        """
        # Copied line for line from larynx_tpu/runtime/engine.py::_grid_vocode_plan.
        n = self._n_data
        if halo is None:
            halo = self._ts_halo
        if area is None:
            area = MAX_VOCODE_AREA
        best: typing.Optional[typing.Tuple[int, int]] = None
        best_w = m  # plain row sharding's per-device work
        for n_rows in range(n, 0, -1):
            if n % n_rows:
                continue
            n_time = n // n_rows
            if n_time > max(m, 1):
                continue
            rows_per = -(-n_valid // n_rows)
            if (n_rows - 1) * rows_per >= n_valid:
                continue  # last row shard would be pure padding
            window = min(
                -(-m // n_time) + (2 * halo if n_time > 1 else 0), m
            )
            work = rows_per * window
            if work >= best_w or work > area:
                continue
            best, best_w = (n_rows, n_time), work
        return best

    def _ragged_group_plan(
        self, sorted_lens: np.ndarray, n_valid: int, m: int, area: int, margin: int = 0
    ) -> typing.List[typing.Tuple[int, int, int]]:
        """[(start, rows, frame_bucket)] over length-descending rows.

        The JAX engine's plan: rows at least half the group width ride
        along, a >= 2x length drop starts a narrower group, group sizes are
        powers of two; large plans ramp the first group (1, 1, 2, ...),
        small ones of <= 8 rows merge into one group at the longest row's
        bucket.
        """
        est_bytes = 2 * self.upsample * sum(
            min(self.policy.mel_bucket(int(n) + margin), m) for n in sorted_lens[:n_valid]
        )
        ramp = est_bytes >= RAMP_MIN_BYTES

        if 1 < n_valid <= 8 and est_bytes < RAMP_MIN_BYTES:
            m_g = min(self.policy.mel_bucket(int(sorted_lens[0]) + margin), m)
            if n_valid * m_g <= area:
                return [(0, n_valid, m_g)]

        plan = []
        start = 0
        while start < n_valid:
            m_g = min(self.policy.mel_bucket(int(sorted_lens[start]) + margin), m)
            remaining = n_valid - start
            fit = max(1, area // m_g)
            ext = 1
            while (
                start + ext < n_valid
                and self.policy.mel_bucket(int(sorted_lens[start + ext])) * 2 > m_g
            ):
                ext += 1
            group = 1 << (min(fit, ext, remaining).bit_length() - 1)
            if ramp and start == 0 and 1 < group < n_valid:
                size = 1
                while size <= group // 2:
                    plan.append((start, size, m_g))
                    start += size
                    size = min(size * 2, group)
                continue
            plan.append((start, group, m_g))
            start += group
        return plan

    @torch.inference_mode()
    def _get_bias_spec(self) -> torch.Tensor:
        """First-frame magnitude of the vocoder's output for an 88-frame zero
        mel (and, for WaveGlow, a zero prior: sigma 0, NVIDIA's Denoiser mode),
        from the engine's own vocoder params in its vocoder dtype.  Built
        once, under a lock: the scheduler's worker and callers on other
        threads share the engine."""
        if self._bias_spec is None:
            with self._bias_lock:
                if self._bias_spec is None:
                    self._bias_spec = self._compute_bias_spec()
        return self._bias_spec

    def _compute_bias_spec(self) -> torch.Tensor:
        frames = hifi_denoiser.BIAS_MEL_FRAMES
        zeros = torch.zeros((1, frames, self.num_mels), device=self.device, dtype=self.voc_dtype)
        z = None
        if self.vocoder_kind == "waveglow":
            cfg = self.vocoder_cfg
            z = torch.zeros((1, frames * cfg.upsample_stride // cfg.groups, cfg.groups),
                            device=self.device, dtype=self.voc_dtype)
        return hifi_denoiser.compute_bias_spec(
            self._generate(zeros, z),
            self.audio_settings.filter_length,
            self.audio_settings.hop_length,
        )

    # ------------------------------------------------------------------
    # host side

    @staticmethod
    def vocode_collect(parts, b: int) -> typing.List[np.ndarray]:
        """Vocode parts -> per-row int16 arrays in original row order; waits
        on each part's copy."""
        rows: typing.List[typing.Optional[np.ndarray]] = [None] * b
        with trace.span("engine.collect", parts=len(parts)):
            for part, idxs in parts:
                arr = part.numpy()
                for j, i in enumerate(idxs):
                    if i < b:
                        rows[i] = arr[j]
        return [r if r is not None else np.zeros((0,), np.int16) for r in rows]

    def crop_rows(self, audio_rows, y_lengths: np.ndarray, n: int, denoiser_strength):
        """Per-sentence valid-sample crops of vocode_collect's rows."""
        denoised = bool(np.any(np.asarray(denoiser_strength) > 0))
        fft = self.audio_settings.filter_length
        hop = self.audio_settings.hop_length
        out = []
        with trace.span("engine.crop", rows=n):
            for i in range(n):
                n_samples = int(y_lengths[i]) * self.upsample
                if self.vocoder_kind == "griffin_lim":
                    # (frames - 1) usable spectrogram frames
                    n_samples = max(int(y_lengths[i]) - 1, 1) * hop + fft
                elif denoised:
                    n_samples = dsp.num_frames(n_samples, fft, hop) * hop + fft
                n_samples = min(n_samples, audio_rows[i].shape[-1])
                out.append(np.ascontiguousarray(audio_rows[i][:n_samples]))
        return out

    @torch.inference_mode()
    def synthesize_launch(
        self,
        enc_out,
        y_lengths: np.ndarray,
        g,
        n: int,
        noise_scale=0.667,
        seed: typing.Optional[int] = None,
        batch_index: int = 0,
        denoiser_strength=0.0,
        row_seeds: typing.Optional[typing.Sequence[typing.Optional[int]]] = None,
    ) -> typing.Tuple[typing.List[typing.Any], int]:
        """Decode + vocode of an encoded batch at the exact mel bucket ->
        (parts, batch rows); the parts' copies have started
        (:meth:`vocode_collect` waits on them)."""
        mel, z_mask = self.decode_launch(
            enc_out, y_lengths, g, n, noise_scale=noise_scale, seed=seed,
            batch_index=batch_index, row_seeds=row_seeds,
        )
        parts = self.vocode_launch(
            mel, z_mask, n, denoiser_strength, y_lengths=y_lengths,
            seed=seed, batch_index=batch_index,
        )
        return parts, mel.shape[0]

    @torch.inference_mode()
    def synthesize_launch_predicted(
        self,
        enc_out,
        g,
        n: int,
        max_id_len: int,
        noise_scale=0.667,
        length_scale=1.0,
        seed: typing.Optional[int] = None,
        batch_index: int = 0,
        denoiser_strength=0.0,
        row_seeds: typing.Optional[typing.Sequence[typing.Optional[int]]] = None,
    ):
        """Decode at the predicted bucket (:meth:`decode_launch_predicted`)
        + vocode -> (parts, batch rows, y_lengths numpy)."""
        mel, z_mask, y_lengths = self.decode_launch_predicted(
            enc_out, g, n, max_id_len, noise_scale=noise_scale, length_scale=length_scale,
            seed=seed, batch_index=batch_index, row_seeds=row_seeds,
        )
        parts = self.vocode_launch(
            mel, z_mask, n, denoiser_strength, y_lengths=y_lengths,
            seed=seed, batch_index=batch_index,
        )
        return parts, mel.shape[0], y_lengths

    def synthesize_batch(
        self,
        id_seqs: typing.Sequence[np.ndarray],
        noise_scale: float = 0.667,
        length_scale: float = 1.0,
        seed: typing.Optional[int] = None,
        denoiser_strength: float = 0.0,
        batch_index: int = 0,
        speaker_ids: typing.Optional[typing.Sequence[int]] = None,
    ) -> typing.List[np.ndarray]:
        """Synthesize a group of sentences (same text bucket) to int16 audio:
        the gated encode + decode, else encode then the predicted decode,
        then vocode."""
        n = len(id_seqs)
        with trace.span("engine.batch", id=next(self._calls), rows=n) as span:
            fused = None
            if seed is None:
                fused = self.encode_decode_launch_predicted(
                    id_seqs, length_scale, speaker_ids=speaker_ids, noise_scale=noise_scale,
                    batch_index=batch_index,
                )
            if fused is not None:
                mel, z_mask, y_lengths, _g = fused
                parts = self.vocode_launch(mel, z_mask, n, denoiser_strength,
                                           y_lengths=y_lengths, batch_index=batch_index)
                b_rows = mel.shape[0]
            else:
                enc_out, g = self.encode_launch(id_seqs, length_scale, speaker_ids=speaker_ids)
                parts, b_rows, y_lengths = self.synthesize_launch_predicted(
                    enc_out, g, n, max((len(s) for s in id_seqs), default=0),
                    noise_scale=noise_scale, length_scale=length_scale, seed=seed,
                    batch_index=batch_index, denoiser_strength=denoiser_strength,
                )
            span.set(bucket=b_rows)
            audio_rows = self.vocode_collect(parts, b_rows)
            return self.crop_rows(audio_rows, y_lengths, n, denoiser_strength)

    # ------------------------------------------------------------------
    # streaming

    def _vocode_stream(self, mel, z_mask, start: int, window: int, bias_spec, strength,
                       denoise: bool) -> torch.Tensor:
        """One haloed window [start, start + window) of the mel at fixed gain
        -> int16 [1, window * upsample (+ STFT tail)]: no per-utterance peak
        normalisation (the generator's tanh already bounds the waveform)."""
        mel_c, mask_c = mel[:, start : start + window], z_mask[:, start : start + window]
        trace.count("engine.vocode_frames", mel_c.shape[0] * mel_c.shape[1])
        audio = self._generate(postprocess(mel_c, mask_c, self.audio_settings).transpose(1, 2))
        if denoise:
            fft, hop = self.audio_settings.filter_length, self.audio_settings.hop_length
            audio = hifi_denoiser.denoise(audio, bias_spec, strength, fft, hop) / ola_gain(fft, hop)
        return torch.clamp(audio * 32767.0, -32767.0, 32767.0).to(torch.int16)

    @torch.inference_mode()
    def synthesize_stream(
        self,
        ids: np.ndarray,
        noise_scale: float = 0.667,
        length_scale: float = 1.0,
        seed: typing.Optional[int] = None,
        denoiser_strength: float = 0.0,
        chunk_frames: int = 64,
        speaker_ids: typing.Optional[typing.Sequence[int]] = None,
    ) -> typing.Iterator[np.ndarray]:
        """Chunked synthesis of ONE utterance: yields int16 audio chunks of
        ``chunk_frames`` mel frames each (the last one shorter).

        Each chunk is vocoded over a window of ``chunk_frames + 2 * halo``
        frames (:func:`stream_halo_frames`, plus the STFT frames that
        straddle a boundary with the denoiser), slid inward at the mel
        bucket's edges, so its samples are those of the one-window run.
        Chunk i + 1 is launched before chunk i is copied to the host (a
        blocking copy).  ``speaker_ids`` ([k]) picks a multi-speaker voice's
        speaker.  The decode runs at the exact mel bucket.  On a mesh the
        stream runs on the first position alone.

        Traced as ``engine.stream`` (the call to its last chunk) and one
        ``engine.stream_chunk`` per chunk: the generator's own time from the
        call (chunk 0: the time to the first chunk) or from its resumption
        to the chunk's yield, the consumer's time between them left out."""
        if self.vocoder_kind != "hifi_gan":
            raise ValueError(
                "streaming synthesis requires a HiFi-GAN vocoder "
                f"(engine has vocoder_kind={self.vocoder_kind!r})"
            )
        call = next(self._calls)
        t_call = t_chunk = time.perf_counter_ns()
        chunk = 0
        try:
            for audio in self._stream_chunks(ids, noise_scale, length_scale, seed,
                                             denoiser_strength, chunk_frames, speaker_ids):
                trace.record("engine.stream_chunk", t_chunk, id=call, chunk=chunk)
                yield audio
                t_chunk = time.perf_counter_ns()
                chunk += 1
        finally:
            trace.record("engine.stream", t_call, id=call, chunks=chunk)

    def _stream_chunks(self, ids, noise_scale, length_scale, seed, denoiser_strength,
                       chunk_frames, speaker_ids):
        """:meth:`synthesize_stream`'s chunks, each copied to the host."""
        enc_out, g = self._encode_one([ids], length_scale, speaker_ids=speaker_ids)
        y_lengths = self.host_lengths(enc_out, 1)
        n_frames = int(y_lengths[0])
        mel, z_mask = self.decode_launch(enc_out, y_lengths, g, 1, noise_scale=noise_scale,
                                         seed=seed)
        m_bucket = mel.shape[1]

        denoise = bool(np.any(np.asarray(denoiser_strength) > 0))
        halo = stream_halo_frames(self.vocoder_cfg)
        if denoise:
            halo += self.audio_settings.filter_length // self.audio_settings.hop_length + 1
        bias = self._get_bias_spec() if denoise else None
        strength = self._row_param(denoiser_strength, 1, 3)

        window = min(chunk_frames + 2 * halo, m_bucket)
        prev = None
        for start in range(0, n_frames, chunk_frames):
            emit = min(chunk_frames, n_frames - start)
            # slide the window inward at the edges: its boundaries then
            # coincide with the true array edges, keeping exactness
            w_start = min(max(start - halo, 0), m_bucket - window)
            audio_c = self._vocode_stream(mel, z_mask, w_start, window, bias, strength, denoise)
            if prev is not None:
                yield prev.cpu().numpy()
            off = (start - w_start) * self.upsample
            prev = audio_c[0, off : off + emit * self.upsample]
        if prev is not None:
            yield prev.cpu().numpy()

    @torch.inference_mode()
    def phonemes_to_mels(self, ids: np.ndarray, noise_scale=0.667, length_scale=1.0,
                         seed: typing.Optional[int] = None,
                         speaker_id: typing.Optional[int] = None) -> np.ndarray:
        """One id sequence -> its raw (normalised) mel [1, C, frames], float32
        numpy, decoded at its mel bucket with the noise of (seed or the
        engine's seed, batch 0); ``speaker_id`` for a multi-speaker voice.
        On a mesh it runs on the first position."""
        speaker_ids = None if speaker_id is None else [int(speaker_id)]
        enc_out, g = self._encode_one([np.asarray(ids)], length_scale, speaker_ids=speaker_ids)
        y_lengths = self.host_lengths(enc_out, 1)
        mel, _ = self.decode_launch(enc_out, y_lengths, g, 1, noise_scale=noise_scale, seed=seed)
        frames = int(y_lengths[0])
        return mel[0:1, :frames].float().transpose(1, 2).cpu().numpy()

    def warmup(self, text_lengths=(16, 64), batch_sizes=(1,)):
        """Run each (batch, text length) shape once."""
        rng = np.random.default_rng(0)
        for b in batch_sizes:
            for t in text_lengths:
                seqs = [
                    rng.integers(1, self.glow_cfg.num_symbols, size=t).astype(np.int64)
                    for _ in range(b)
                ]
                self.synthesize_batch(seqs)
