"""GlowTTS training: monotonic alignment search, losses, the forward pass.

Counterpart of ``larynx_tpu/models/glow_tts/training.py``.  Maximum
likelihood through the forward flow (mel -> latent z with its
log-determinant), with the hard alignment that monotonic alignment search
(MAS) picks between phonemes and frames.  MAS stays on the tensors'
device: a forward pass over the mel frames, then a backtrack, as torch
ops, with no copy to the host.  Gradients stop where the JAX package stops
them: MAS and its inputs, and the duration predictor's input (``encode``).

Data parallel (``parallel/train.py``): ``reduce`` is the sum over the data
group.  The losses divide their local numerators by the global
denominators (the JAX step's are over the whole batch), the constant of
the MLE loss is added on the first data rank alone, and DDI takes its
masked sums over the global batch, so the ranks' losses sum to the global
loss and every rank gets the same init.
"""

import math
import typing

import torch

from larynx_tpu_torch.models.glow_tts import flows
from larynx_tpu_torch.models.glow_tts.config import GlowTTSConfig
from larynx_tpu_torch.models.glow_tts.model import encode, speaker_embedding

Params = typing.Dict[str, typing.Any]

NEG_INF = -1e9


@torch.no_grad()
def maximum_path(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Monotonic alignment search (Viterbi).

    value: [B, T_x, T_y] log-likelihood of phoneme i explaining frame j;
    mask: [B, T_x, T_y] valid region (x_mask x y_mask).  Returns the hard
    path [B, T_x, T_y] in {0, 1}, in value's dtype.  The steps are JAX's
    scans: a forward pass over T_y that keeps, per frame, whether each
    phoneme's best predecessor is itself ("stay"); then a backtrack from
    each sequence's last phoneme.
    """
    b, t_x, t_y = value.shape
    device = value.device
    cols = (value * mask).float().permute(2, 0, 1).contiguous()  # [T_y, B, T_x]
    x_range = torch.arange(t_x, device=device)
    # phoneme i is reachable at frame j only if i <= j
    unreachable = x_range[None, :] > torch.arange(t_y, device=device)[:, None]  # [T_y, T_x]

    # v at [:, 1:], NEG_INF at [:, 0]: [:, :-1] is v shifted by one phoneme
    planes = [torch.full((b, t_x + 1), NEG_INF, device=device) for _ in range(2)]
    planes[0][:, 1:] = 0.0
    stay = torch.empty((t_y, b, t_x), dtype=torch.bool, device=device)
    for j in range(t_y):
        cur, nxt = planes[j % 2], planes[(j + 1) % 2]
        v, v0 = cur[:, 1:], cur[:, :-1]
        torch.ge(v, v0, out=stay[j])
        v_next = nxt[:, 1:]
        torch.maximum(v, v0, out=v_next)
        v_next.add_(cols[j]).masked_fill_(unreachable[j], NEG_INF)

    # step[j]: the phoneme index's change from frame j to frame j - 1
    # (0 to stay, -1 to move up); invalid cells and frames stay
    valid = mask.permute(2, 0, 1) > 0  # [T_y, B, T_x]
    step = torch.where(valid & ~stay, -1, 0)
    y_valid = mask[:, 0, :].permute(1, 0) > 0  # [T_y, B]
    step = step * y_valid[..., None]
    x_lengths = mask[:, :, 0].sum(dim=1).to(torch.int64)
    index = torch.empty((t_y, b), dtype=torch.int64, device=device)
    index[t_y - 1] = x_lengths - 1
    for j in range(t_y - 1, 0, -1):
        moved = torch.gather(step[j], 1, index[j][:, None])[:, 0]
        torch.add(index[j], moved, out=index[j - 1]).clamp_(0, t_x - 1)
    path = x_range[None, :, None] == index.permute(1, 0)[:, None, :]
    return path.to(value.dtype) * mask


def intersperse(lst: typing.Sequence, item) -> typing.List:
    """[a, b] -> [item, a, item, b, item]."""
    result = [item] * (len(lst) * 2 + 1)
    result[1::2] = list(lst)
    return result


@torch.no_grad()
def actnorm_ddi_init(
    params: Params,
    cfg: GlowTTSConfig,
    mels: torch.Tensor,
    mel_lengths: torch.Tensor,
    speaker_ids: typing.Optional[torch.Tensor] = None,
    reduce: typing.Optional[typing.Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Params:
    """Data-dependent init of every ActNorm from a warmup batch: each
    block's ActNorm is set from the masked mean and variance of its own
    input, which depends on the blocks before it, so the blocks go front
    to back.  With ``reduce`` the masked sums are the global batch's.
    Returns new params; the others are shared."""
    g = None
    if speaker_ids is not None and "emb_g" in params:
        g = speaker_embedding(params, speaker_ids)
    mel_lengths = (mel_lengths // cfg.n_sqz) * cfg.n_sqz
    m = mels.shape[1]
    y_mask = (torch.arange(m, device=mels.device)[None, :] < mel_lengths[:, None]).float()
    x, sq_mask = flows.squeeze(mels, y_mask, cfg.n_sqz)
    mask3 = sq_mask[..., None]

    blocks = params["decoder"]
    new_logs, new_bias = [], []
    for r in range(cfg.n_blocks_dec):
        block = flows._block(blocks, r)
        sums = torch.cat([mask3.sum(dim=(0, 1)), (x * mask3).sum(dim=(0, 1)),
                          (x.square() * mask3).sum(dim=(0, 1))])
        if reduce is not None:
            sums = reduce(sums)
        c = x.shape[-1]
        denom = sums[:1]
        mean = sums[1 : 1 + c] / denom
        mean_sq = sums[1 + c :] / denom
        logs = 0.5 * torch.log(torch.clamp(mean_sq - mean.square(), min=1e-6))
        bias = -mean * torch.exp(-logs)
        new_logs.append(-logs)
        new_bias.append(bias)
        block["actnorm"] = {"logs": -logs, "bias": bias}
        x, _ = flows.flow_step(block, x, sq_mask, cfg, reverse=False, g=g)

    decoder = dict(blocks, actnorm={"logs": torch.stack(new_logs), "bias": torch.stack(new_bias)})
    return dict(params, decoder=decoder)


def _global(x: torch.Tensor, reduce) -> torch.Tensor:
    return x if reduce is None else reduce(x)


def mle_loss(z, m, logs, logdet, mask, reduce=None, first: bool = True) -> torch.Tensor:
    """Flow maximum-likelihood loss.  z/m/logs: [B, M, C]; logdet: [B];
    mask: [B, M].  With ``reduce``, this rank's share: the local numerator
    over the global denominator, the constant on the ``first`` rank."""
    mask3 = mask[..., None]
    loss = torch.sum(logs * mask3) + 0.5 * torch.sum(
        torch.exp(-2 * logs) * (z - m).square() * mask3)
    loss = loss - torch.sum(logdet)
    loss = loss / (_global(torch.sum(mask3), reduce) * z.shape[-1])
    return loss + 0.5 * math.log(2 * math.pi) if first else loss


def duration_loss(logw, logw_hat, lengths, reduce=None) -> torch.Tensor:
    """L2 log-duration loss (with ``reduce``, this rank's share)."""
    return torch.sum((logw - logw_hat).square()) / _global(torch.sum(lengths.float()), reduce)


def alignment_log_likelihood(z: torch.Tensor, x_m: torch.Tensor,
                             x_logs: torch.Tensor) -> torch.Tensor:
    """logp [B, T_x, M]: the Gaussian log-likelihood of frame j's latent
    under phoneme i's (mean, log-scale), summed over channels, as three
    products instead of a [B, T_x, M, C] broadcast."""
    x_s_sq_r = torch.exp(-2 * x_logs)  # [B, T_x, C]
    logp1 = torch.sum(-0.5 * math.log(2 * math.pi) - x_logs, dim=-1, keepdim=True)
    logp2 = torch.einsum("btc,bmc->btm", -0.5 * x_s_sq_r, z.square())
    logp3 = torch.einsum("btc,bmc->btm", x_m * x_s_sq_r, z)
    logp4 = torch.sum(-0.5 * x_m.square() * x_s_sq_r, dim=-1, keepdim=True)
    return logp1 + logp2 + logp3 + logp4


def training_forward(
    params: Params,
    cfg: GlowTTSConfig,
    ids: torch.Tensor,
    id_lengths: torch.Tensor,
    mels: torch.Tensor,
    mel_lengths: torch.Tensor,
    g: typing.Optional[torch.Tensor] = None,
    reduce: typing.Optional[typing.Callable[[torch.Tensor], torch.Tensor]] = None,
    first: bool = True,
    tp=None,
):
    """One training forward pass -> (loss, metrics dict of scalars).

    ids [B, T]; mels [B, M, C] normalised log-mels, channels-last; the mel
    length is cut to a multiple of n_sqz.  ``reduce``/``first``: this data
    rank's share of the global losses (:func:`mle_loss`); ``tp``: the
    encoder's model axis (``parallel/train.py::ModelAxis``)."""
    mel_lengths = (mel_lengths // cfg.n_sqz) * cfg.n_sqz
    x_m, x_logs, logw, _w_ceil, _y_lengths, x_mask = encode(params, cfg, ids, id_lengths, g=g,
                                                            tp=tp)
    m = mels.shape[1]
    y_mask = (torch.arange(m, device=mels.device)[None, :] < mel_lengths[:, None]).float()

    z, logdet = flows.decoder(params["decoder"], mels, y_mask, cfg, reverse=False, g=g)

    logp = alignment_log_likelihood(z.detach(), x_m.detach(), x_logs.detach())
    attn = maximum_path(logp, x_mask[:, :, None] * y_mask[:, None, :])

    z_m = torch.einsum("btm,btc->bmc", attn, x_m)
    z_logs = torch.einsum("btm,btc->bmc", attn, x_logs)
    logw_hat = torch.log(1e-8 + attn.sum(dim=2)) * x_mask

    l_mle = mle_loss(z, z_m, z_logs, logdet, y_mask, reduce=reduce, first=first)
    l_dur = duration_loss(logw, logw_hat, id_lengths, reduce=reduce)
    loss = l_mle + l_dur
    return loss, {"mle_loss": l_mle.detach(), "duration_loss": l_dur.detach(),
                  "loss": loss.detach()}
