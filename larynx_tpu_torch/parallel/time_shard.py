"""Vocoding along time as well as rows, over the serving mesh's positions.

Counterpart of ``larynx_tpu/parallel/time_shard.py``.  Row sharding gives
one long utterance nothing; here its vocode is split along time.  On an
``n_rows x n_time`` grid of positions, row shard r's rows go to its n_time
positions, and position (r, t) vocodes a haloed mel window ``chunk + 2 *
halo`` frames wide, slid inward at the mel's edges (the streaming chunker's
receptive-field construction), and keeps its chunk.  A chunk's samples
equal those of the batched program wherever the halo covers the receptive
field, up to the float sums' order in another window width (one int16 step
on a small share of samples: ``tests/test_torch_time_shard.py``).

Each window's per-row peaks over the valid samples go to the row shard's
first position (``.to(device, non_blocking=True)``), are max-reduced there
and sent back, so every chunk of a row scales by the row's one peak; there
is no host sync between positions.  Without the denoiser each position
converts its chunk to int16 and starts its copy to pinned host memory
(``runtime/engine.py::HostCopy``).  The denoiser's STFT is not chunk-local:
with it, the float chunks of a row shard are gathered onto its first
position, which denoises, normalises and converts the whole rows (JAX's
second, global program).  Rows are padded to a multiple of n_rows with
silence, frames to a multiple of n_time.

Latency model (JAX's): per position the window is ``M / N + 2 * halo`` mel
frames, so the cut over one device is ``speedup(N) = M / (M / N + 2 *
halo)``.  Positions that repeat one device run their windows one after
another and pay the halos without the speed-up.
"""

import typing

import numpy as np
import torch

from larynx_tpu_torch.audio import AudioSettings
from larynx_tpu_torch.models.hifi_gan import denoiser as hifi_denoiser
from larynx_tpu_torch.models.hifi_gan import model as hifi_model
from larynx_tpu_torch.models.waveglow import model as wg_model
from larynx_tpu_torch.runtime import trace
from larynx_tpu_torch.runtime.engine import SILENCE_LOG_MEL, HostCopy, postprocess

Replicas = typing.Mapping[torch.device, typing.Any]


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


class GridPart:
    """One row shard's int16 audio on the host: its chunks' copies (or one
    copy of the whole rows) joined along time, cropped to ``samples``."""

    def __init__(self, copies: typing.List[HostCopy], samples: int):
        self._copies = copies
        self._samples = samples

    def numpy(self) -> np.ndarray:
        arrays = [c.numpy() for c in self._copies]
        return np.concatenate(arrays, axis=1)[:, : self._samples]


class GridOutput:
    """The grid's output: ``parts`` [(GridPart, row indices)] for the
    engine's ``vocode_collect``, and :meth:`numpy` for the whole int16
    [B, M * upsample] batch."""

    def __init__(self, parts, b: int):
        self.parts = parts
        self._b = b

    def numpy(self) -> np.ndarray:
        rows = []
        for part, idxs in self.parts:
            arr = part.numpy()
            rows.extend(arr[: len(idxs)])
        return np.stack(rows[: self._b])


def _int16_scale(audio: torch.Tensor, peak: torch.Tensor) -> torch.Tensor:
    scaled = torch.clamp(audio * (32767.0 / torch.clamp(peak, min=0.01)), -32767.0, 32767.0)
    return scaled.to(torch.int16)


def _grid_vocode(generate, upsample: int, blocks_per_frame: int, settings: AudioSettings,
                 devices, n_rows: int, n_time: int, halo: int):
    """The grid program of both families.  ``generate(params, mel [B, M, C]
    float32 post-processed, z or None)`` -> float32 audio [B, M * upsample]."""
    positions = [torch.device(d) for d in devices]
    if len(positions) != n_rows * n_time:
        raise ValueError(f"grid {n_rows}x{n_time} needs {n_rows * n_time} devices, "
                         f"got {len(positions)}")
    fft, hop = settings.filter_length, settings.hop_length

    def window(params, mel, z_mask, z, t):
        """Position t of a row shard: its chunk as float audio, and the
        rows' peaks over the chunk's valid samples."""
        m = mel.shape[1]
        chunk = m // n_time
        width = min(chunk + 2 * halo, m)
        w_start = min(max(t * chunk - halo, 0), m - width)
        trace.count("engine.vocode_frames", mel.shape[0] * width)
        mel_pp = postprocess(mel[:, w_start : w_start + width],
                             z_mask[:, w_start : w_start + width], settings)
        z_w = None
        if z is not None:
            z_w = z[:, w_start * blocks_per_frame : (w_start + width) * blocks_per_frame]
        audio_w = generate(params, mel_pp.transpose(1, 2), z_w)
        off = (t * chunk - w_start) * upsample
        audio_c = audio_w[:, off : off + chunk * upsample]
        # the FULL row's valid count: every window of a row sees the same
        n_valid = (z_mask > 0).sum(dim=1) * upsample
        index = t * chunk * upsample + torch.arange(chunk * upsample, device=mel.device)
        valid = index[None, :] < n_valid[:, None]
        return audio_c, torch.where(valid, audio_c.abs(), 0.0).amax(dim=-1), n_valid

    def run(voc_params: Replicas, mel: torch.Tensor, z_mask: torch.Tensor,
            z: typing.Optional[torch.Tensor] = None, bias_spec=None, strength=None,
            denoise: bool = False) -> GridOutput:
        b, m = mel.shape[0], mel.shape[1]
        m_pad, b_pad = _round_up(m, n_time), _round_up(b, n_rows)
        pad = torch.nn.functional.pad
        if m_pad != m or b_pad != b:
            mel = pad(mel, (0, 0, 0, m_pad - m, 0, b_pad - b), value=SILENCE_LOG_MEL)
            z_mask = pad(z_mask, (0, m_pad - m, 0, b_pad - b))
            if z is not None:
                z = pad(z, (0, 0, 0, (m_pad - m) * blocks_per_frame, 0, b_pad - b))
        per = b_pad // n_rows
        parts = []
        for r in range(n_rows):
            rows = slice(r * per, (r + 1) * per)
            cells = positions[r * n_time : (r + 1) * n_time]
            outs = []
            for t, dev in enumerate(cells):
                move = lambda x: None if x is None else x[rows].to(dev, non_blocking=True)  # noqa: E731,B023
                outs.append(window(voc_params[dev], move(mel), move(z_mask), move(z), t))
            head = cells[0]
            # the rows' peak: max over this shard's windows, on its first position
            peak = torch.stack([p.to(head, non_blocking=True) for _a, p, _n in outs]).amax(0)
            idxs = [i for i in range(r * per, (r + 1) * per) if i < b]
            if not idxs:
                continue
            if not denoise:
                copies = [HostCopy(_int16_scale(a, peak.to(a.device, non_blocking=True)[:, None]))
                          for a, _p, _n in outs]
                parts.append((GridPart(copies, m * upsample), idxs))
                continue
            audio = torch.cat([a.to(head, non_blocking=True) for a, _p, _n in outs], dim=1)
            audio = audio[: len(idxs)]
            s = strength
            if isinstance(s, torch.Tensor) and s.ndim:
                s = s[idxs[0] : idxs[-1] + 1].to(head)
            audio = hifi_denoiser.denoise(audio, bias_spec.to(head), s, fft, hop)
            n_valid = outs[0][2].to(head)[: len(idxs)]
            nf = torch.clamp(n_valid - fft, min=0)
            n_valid = (nf + hop - 1) // hop * hop + fft
            valid = torch.arange(audio.shape[-1], device=head)[None, :] < n_valid[:, None]
            row_peak = torch.where(valid, audio.abs(), 0.0).amax(dim=-1, keepdim=True)
            parts.append((GridPart([HostCopy(_int16_scale(audio, row_peak))], m * upsample),
                          idxs))
        return GridOutput(parts, b)

    return run


def make_grid_sharded_vocode(voc_cfg, settings: AudioSettings, devices, n_rows: int,
                             n_time: int, halo: int, voc_dtype=torch.float32):
    """``fn(voc_params {device: packed params}, mel [B, M, C], z_mask [B, M],
    bias_spec=None, strength=None, denoise=False)`` -> :class:`GridOutput`:
    HiFi-GAN over an ``n_rows x n_time`` grid of ``devices`` (positions).
    ``mel`` is the engine's raw (normalised) mel; the post-processing runs
    per window, as the engine's batched vocode does."""
    def generate(params, mel, _z):
        return hifi_model.generator(params, voc_cfg, mel.to(voc_dtype)).float()

    run = _grid_vocode(generate, voc_cfg.total_upsample, 0, settings, devices, n_rows, n_time,
                       halo)
    return lambda voc_params, mel, z_mask, bias_spec=None, strength=None, denoise=False: run(
        voc_params, mel, z_mask, None, bias_spec, strength, denoise)


def make_time_sharded_vocode(voc_cfg, settings: AudioSettings, mesh, halo: int,
                             voc_dtype=torch.float32):
    """One row's mel [1, M, C] time-sharded over every position of a
    ``ServingMesh``: the ``1 x N`` grid."""
    return make_grid_sharded_vocode(voc_cfg, settings, mesh.positions, 1, len(mesh), halo,
                                    voc_dtype=voc_dtype)


def waveglow_halo_frames(voc_cfg) -> int:
    """Mel-frame halo covering WaveGlow's receptive field (JAX's): per flow
    ``(k - 1) / 2 * (2^layers - 1)`` blocks a side, chained over the flows,
    in frames of ``stride / groups`` blocks, widened by the conditioning
    transposed conv's ``kernel / stride`` frames; ~100 at wn_256."""
    per_flow = (voc_cfg.wn_kernel_size - 1) // 2 * (2**voc_cfg.wn_layers - 1)
    blocks_per_frame = voc_cfg.upsample_stride // voc_cfg.groups
    cond_margin = -(-voc_cfg.upsample_kernel // voc_cfg.upsample_stride)
    return -(-voc_cfg.flows * per_flow // blocks_per_frame) + cond_margin


def make_waveglow_grid_vocode(voc_cfg, settings: AudioSettings, devices, n_rows: int,
                              n_time: int, halo: int, voc_dtype=torch.float32):
    """WaveGlow's grid: ``fn(voc_params, mel, z_mask, z [B, blocks, groups],
    bias_spec=None, strength=None, denoise=False)`` -> :class:`GridOutput`.
    ``z`` is the engine's prior, drawn once for the batch and zeroed past
    each row's valid blocks; each window takes its haloed span of it."""
    def generate(params, mel, z):
        return wg_model.infer(params, voc_cfg, mel.to(voc_dtype), z=z.to(voc_dtype)).float()

    return _grid_vocode(generate, voc_cfg.upsample_stride,
                        voc_cfg.upsample_stride // voc_cfg.groups, settings, devices, n_rows,
                        n_time, halo)
