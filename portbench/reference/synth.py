"""The plain reference of a request's audio: the acoustic model in float64,
the vocoder in float32 (TF32 off), under the engine's rules (``rules.py``).
Each model's calls come from its kind's module (``kinds/<kind>.py``).

``Reference(..., control="all")`` is the lower-precision control: the
acoustic model in float32 with TF32 on, the vocoder's products on inputs and weights
rounded to float8 (e4m3, one scale per tensor), the step below each
precision that the configuration states.  A vocoder kind may name further
controls in its ``CONTROLS``: ``"wn"`` rounds only WaveGlow's WN products
so, and keeps the rest as the reference has it.
"""

import contextlib

import numpy as np
import torch

from portbench import kinds
from portbench.reference import rules

# a duration whose float64 value lies this close (relative) to an integer
# may take the other ceiling in float32: its row's length is ambiguous
DURATION_RTOL = 2e-5


def _fp8(x):
    """x rounded to float8 e4m3 at one scale for the tensor (amax -> 448)."""
    amax = x.detach().abs().amax().float().clamp(min=1e-12)
    scale = 448.0 / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


@contextlib.contextmanager
def _tf32(on):
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


class Encoded:
    """A batch's encode: the tensors the decode needs and, on the host, each
    row's length and whether it is ambiguous."""

    def __init__(self, out, n):
        self.x_m, self.w_ceil, self.mask = out["x_m"], out["w_ceil"], out["mask"]
        self.y_len = out["y_lengths"][:n].cpu().numpy().astype(np.int64)
        w = out["w"][:n]
        near = (w - torch.round(w)).abs() <= DURATION_RTOL * torch.clamp(w, min=1.0)
        self.ambiguous = (near & (out["mask"][:n, 0] > 0)).any(dim=1).cpu().numpy()


class Reference:
    def __init__(self, acoustic_params, acoustic_cfg, voc_params, voc_cfg, audio, buckets,
                 device, engine_seed, control=None):
        self.acoustic = kinds.load(acoustic_cfg["kind"])
        self.vocoder = kinds.load(voc_cfg["kind"])
        if control is not None and control not in self.vocoder.CONTROLS:
            raise ValueError(f"no control {control!r} for a {voc_cfg['kind']} vocoder")
        self.glow_cfg, self.voc_cfg, self.audio = acoustic_cfg, voc_cfg, audio
        self.buckets, self.device, self.engine_seed = buckets, device, engine_seed
        self.control = control
        self.tf32 = control == "all"
        self.glow = _cast(acoustic_params, torch.float32 if self.tf32 else torch.float64)
        self.voc = _cast(voc_params, torch.float32)
        self.q = _fp8 if control else None
        self.upsample = self.vocoder.upsample(voc_cfg)

    @torch.no_grad()
    def encode(self, id_seqs, length_scale):
        n = len(id_seqs)
        t = max(len(s) for s in id_seqs)
        ids = torch.zeros((n, t), dtype=torch.int64)
        for i, s in enumerate(id_seqs):
            ids[i, : len(s)] = torch.as_tensor(np.asarray(s, dtype=np.int64))
        lengths = torch.as_tensor([len(s) for s in id_seqs], dtype=torch.int64)
        with _tf32(self.tf32):
            out = self.acoustic.reference.encode(self.glow, self.glow_cfg, ids.to(self.device),
                                                 lengths.to(self.device), length_scale)
        return Encoded(out, n)

    @torch.no_grad()
    def decode(self, enc, rows, m, noise, noise_scale):
        """rows of an encode -> normalised mel [R, C, m] in float32; noise
        [R, m, C] standard normal."""
        ref = self.acoustic.reference
        with _tf32(self.tf32):
            x_m = enc.x_m[rows]
            z_m = ref.expand(x_m, enc.w_ceil[rows], m)
            y_len = torch.as_tensor(enc.y_len[rows], device=self.device)
            y_mask = (torch.arange(m, device=self.device)[None, :] < y_len[:, None]).to(x_m.dtype)
            z = (z_m + noise.transpose(1, 2).to(x_m.dtype) * noise_scale) * y_mask[:, None]
            mel = ref.decode(self.glow, self.glow_cfg, z, y_mask[:, None])
        return mel.float()

    def batch(self, enc, n, m, b_bucket, noise_scale, batch_index=0):
        """``synthesize_batch``'s rows for a batch of n sentences decoded at
        bucket m with the engine's batch noise -> [int16 array] per row."""
        rows = np.arange(n)
        noise = rules.batch_noise(self.engine_seed, batch_index,
                                  (b_bucket, m, self.glow_cfg["mel_channels"]), self.device)[:n]
        mel = self.decode(enc, rows, m, noise, noise_scale)
        mel_pp = rules.postprocess(mel, enc.y_len, self.audio)
        valid = torch.zeros(b_bucket, dtype=torch.int64, device=self.device)
        valid[:n] = torch.as_tensor(enc.y_len, device=self.device)
        prior = self.vocoder.prior(self.engine_seed, batch_index, b_bucket, m, valid,
                                   self.voc_cfg, self.device)
        order = rules.sort_desc(enc.y_len)
        out = [None] * n
        for start, size, width in rules.group_plan(self.buckets, enc.y_len[order], m,
                                                   self.vocoder.AREA, self.upsample):
            idx = order[start : start + size]
            with torch.no_grad(), _tf32(False):
                audio = self.vocoder.vocode(self.voc, self.voc_cfg, mel_pp[idx, :, :width], prior,
                                            idx, width, q=self.q, scope=self.control)
            n_valid = torch.as_tensor(enc.y_len[idx] * self.upsample, device=self.device)
            pcm = rules.to_int16(audio, n_valid).cpu().numpy()
            for j, r in enumerate(idx):
                out[r] = pcm[j, : enc.y_len[r] * self.upsample]
        return out
