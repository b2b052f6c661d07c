"""The serving engine's documented rules that decide what a request's audio
is, restated for the reference: which shapes a batch is padded to, which
mel bucket its decode draws its latent noise at, how its rows are grouped
for the vocoder, how noise and the WaveGlow prior are seeded, and how float
audio becomes int16.

Random latent noise and the vocoder's padded width make a row's audio
depend on these choices, so the reference makes the same ones, from its
own durations.  They are the rules that ``larynx_tpu_torch/runtime/
engine.py`` documents (``SynthesisEngine._ragged_group_plan``,
``_predict_mel_bucket``, ``_noise_generator``, ``_waveglow_prior``,
``to_int16``), written out here; nothing of the port is imported.
"""

import bisect
import math

import numpy as np
import torch

# the engine's defaults
MAX_VOCODE_AREA = 16384  # rows x mel frames per HiFi-GAN call
WAVEGLOW_AREA = MAX_VOCODE_AREA // 4
RAMP_MIN_BYTES = 8_000_000
BUCKET_MARGIN = 1.15
SILENCE_LOG_MEL = float(np.log(1e-5))


def _round_up(x, m):
    return -(-x // m) * m


class Buckets:
    """The bucket tables (from the traffic file) and the rules on them."""

    def __init__(self, tables, n_sqz):
        self.text = tuple(tables["text"])
        self.mel = tuple(tables["mel"])
        self.batch = tuple(tables["batch"])
        self.n_sqz = n_sqz

    def text_bucket(self, n):
        i = bisect.bisect_left(self.text, n)
        return self.text[i] if i < len(self.text) else _round_up(n, self.text[-1])

    def mel_bucket(self, frames):
        frames = _round_up(max(frames, self.n_sqz), self.n_sqz)
        i = bisect.bisect_left(self.mel, frames)
        return self.mel[i] if i < len(self.mel) else _round_up(frames, 512)

    def batch_bucket(self, n):
        i = bisect.bisect_left(self.batch, n)
        return self.batch[i] if i < len(self.batch) else _round_up(n, self.batch[-1])


class Predictor:
    """The engine's predicted mel bucket: an upper bound on frames per id
    at length scale 1 that jumps to a new maximum and decays 1% a batch
    toward smaller observations; the decode runs at the predicted bucket
    when the batch's longest row fits it, else at the exact bucket."""

    def __init__(self, buckets):
        self.buckets = buckets
        self.frames_per_token = 0.0

    def decode_bucket(self, max_id_len, y_max, ls):
        """The bucket a batch decodes at, updating the state."""
        predicted = None
        if self.frames_per_token > 0.0 and max_id_len > 0:
            predicted = self.buckets.mel_bucket(
                int(math.ceil(max_id_len * self.frames_per_token * ls * BUCKET_MARGIN)))
        obs = y_max / (max_id_len * ls)
        self.frames_per_token = (obs if obs > self.frames_per_token
                                 else 0.99 * self.frames_per_token + 0.01 * obs)
        if predicted is not None and y_max <= predicted:
            return predicted
        return self.buckets.mel_bucket(y_max)


def group_plan(buckets, lens_desc, m, area, upsample):
    """[(start, rows, width)] over rows sorted longest first: rows at least
    half the group's width ride along, a 2x drop starts a narrower group,
    group sizes are powers of two, a large batch ramps its first group (1,
    1, 2, ...), and up to 8 small rows go in one group."""
    n = len(lens_desc)
    est = 2 * upsample * sum(min(buckets.mel_bucket(int(x)), m) for x in lens_desc)
    ramp = est >= RAMP_MIN_BYTES
    if 1 < n <= 8 and not ramp:
        width = min(buckets.mel_bucket(int(lens_desc[0])), m)
        if n * width <= area:
            return [(0, n, width)]
    plan, start = [], 0
    while start < n:
        width = min(buckets.mel_bucket(int(lens_desc[start])), m)
        fit = max(1, area // width)
        ext = 1
        while start + ext < n and buckets.mel_bucket(int(lens_desc[start + ext])) * 2 > width:
            ext += 1
        group = 1 << (min(fit, ext, n - start).bit_length() - 1)
        if ramp and start == 0 and 1 < group < n:
            size = 1
            while size <= group // 2:
                plan.append((start, size, width))
                start += size
                size = min(size * 2, group)
            continue
        plan.append((start, group, width))
        start += group
    return plan


def sort_desc(lens):
    """Row order longest first, ties in row order."""
    return np.argsort(-np.asarray(lens), kind="stable")


def generator(entropy, device):
    """A torch generator on ``device`` seeded from SeedSequence(entropy)."""
    state = np.random.SeedSequence([int(e) for e in entropy]).generate_state(1)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]))
    return gen


def batch_noise(engine_seed, batch_index, shape, device):
    """A batch's latent noise [B, M, C] (float32, standard normal)."""
    gen = generator([engine_seed & 0xFFFFFFFF, batch_index], device)
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def waveglow_prior(engine_seed, batch_index, b, m, valid_frames, cfg, sigma, device):
    """sigma * N(0, 1) over [b, m * stride / groups, groups] on the vocoder's
    stream, zeroed past each row's valid blocks."""
    blocks = m * cfg["upsample_stride"] // cfg["groups"]
    gen = generator([engine_seed & 0xFFFFFFFF, batch_index, 1], device)
    z = sigma * torch.randn((b, blocks, cfg["groups"]), device=device, generator=gen)
    per_frame = cfg["upsample_stride"] // cfg["groups"]
    inside = torch.arange(blocks, device=device)[None, :] < (valid_frames * per_frame)[:, None]
    return torch.where(inside[..., None], z, 0.0)


def postprocess(mel, y_len, audio):
    """Normalised mel [B, C, M] -> the vocoder's log mel: denormalise, dB to
    amplitude, log with a 1e-5 floor; frames past y_len are silence."""
    a = audio
    x = mel
    if a["signal_norm"]:
        if a["symmetric_norm"]:
            if a["clip_norm"]:
                x = torch.clamp(x, -a["max_norm"], a["max_norm"])
            x = (x + a["max_norm"]) * -a["min_level_db"] / (2 * a["max_norm"]) + a["min_level_db"]
        else:
            if a["clip_norm"]:
                x = torch.clamp(x, 0, a["max_norm"])
            x = x * -a["min_level_db"] / a["max_norm"] + a["min_level_db"]
        x = x + a["ref_level_db"]
    if a["convert_db_to_amp"]:
        x = torch.pow(10.0, x / a["spec_gain"])
    if a["do_dynamic_range_compression"]:
        x = torch.log(torch.clamp(x, min=1e-5))
    frames = torch.arange(mel.shape[2], device=mel.device)
    valid = frames[None, :] < torch.as_tensor(y_len, device=mel.device)[:, None]
    return torch.where(valid[:, None, :], x, SILENCE_LOG_MEL)


def to_int16(audio, n_valid):
    """Each row scaled so that its peak over the valid samples (at least
    0.01) is 32767, clipped, truncated toward zero."""
    t = audio.shape[-1]
    inside = torch.arange(t, device=audio.device)[None, :] < n_valid[:, None]
    peak = torch.clamp(torch.where(inside, audio.abs(), 0.0).amax(dim=-1, keepdim=True), min=0.01)
    return torch.clamp(audio * (32767.0 / peak), -32767.0, 32767.0).to(torch.int16)
