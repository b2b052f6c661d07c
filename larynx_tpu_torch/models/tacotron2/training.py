"""Tacotron2 teacher-forced training step, on one device.

Counterpart of ``larynx_tpu/models/tacotron2/training.py``.  Loss = MSE of
the decoder's mels and of the postnet's, masked to each row's valid frames,
plus the gate's binary cross-entropy against "1 from the last valid frame
on", unmasked (padding keeps target 1), as NVIDIA's loss.  The optimizer is
``parallel/train.py``'s ``Optimizer`` with a global-norm clip and AdamW at
a linear warmup.

Two things differ from the JAX package on purpose:

* Dropout masks enter as tensors (``draw_train_masks``): torch cannot draw
  the bits of JAX's ``fold_in`` keys.  The CLI seeds each step's masks by
  ``SeedSequence([seed + 1, step])``, where JAX folds the step into
  ``PRNGKey(seed + 1)``.
* Every BatchNorm's running ``mean``/``var`` follows the batch statistics
  by an exponential moving average at momentum 0.1 (NVIDIA's, with
  ``torch.nn.BatchNorm1d``'s rule: the variance's batch value unbiased),
  and no optimizer touches them.  The JAX step discards the batch
  statistics, so a JAX-trained voice normalises with its init's 0 and 1 at
  inference, and adamw's decay shrinks the ``var`` leaves.

Data parallel on a ``TrainMesh`` (``parallel/train.py``): every rank draws
the global batch's masks and takes its rows.  The mel losses divide by the
global valid-frame count and the gate's by the global element count, and
the BatchNorms' train-mode statistics, and their EMA's count, are the
global batch's (sums over the data group, differentiable), as JAX's one
global program computes them.
"""

import math
import typing
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from larynx_tpu_torch.device import to_device
from larynx_tpu_torch.models.tacotron2 import model as t2_model
from larynx_tpu_torch.models.tacotron2.config import Tacotron2Config
from larynx_tpu_torch.parallel.train import (
    Optimizer,
    OptState,
    batch_to,
    data_sum,
    local_rows,
    reduce_grads,
    trainable,
    zero_grads,
)

BN_MOMENTUM = 0.1
# the running statistics: no gradient, no optimizer, EMA only
BN_RUNNING = ("mean", "var")
ENCODER_DROPOUT = 0.5  # fixed in the JAX package's encode


@dataclass
class Tacotron2TrainState:
    params: typing.Any
    opt_state: OptState
    step: int = 0


def init_train_state(params, optimizer: Optimizer) -> Tacotron2TrainState:
    """Params (the port's layout, on their device) -> trainable leaves,
    every BatchNorm's ``mean``/``var`` excepted, with a fresh optimizer."""
    params = trainable(params, frozen=BN_RUNNING)
    return Tacotron2TrainState(params=params, opt_state=optimizer.init(params))


def draw_train_masks(cfg: Tacotron2Config, bsz: int, t: int, s: int, seed: int, step: int,
                     device) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """One step's dropout keep masks on ``device``: (encoder [n_conv, B, T,
    E], prenet [2, B, S, prenet_dim]), bool, keep = u < 1 - p with u uniform
    from a ``torch.Generator`` seeded by ``SeedSequence([seed, step])``,
    drawn on the host and copied in one transfer."""
    state = np.random.SeedSequence([seed & 0xFFFFFFFF, step]).generate_state(1)
    gen = torch.Generator().manual_seed(int(state[0]))
    enc_shape = (cfg.encoder_n_convolutions, bsz, t, cfg.encoder_embedding_dim)
    pre_shape = (2, bsz, s, cfg.prenet_dim)
    n_enc = math.prod(enc_shape)
    u = torch.rand(n_enc + math.prod(pre_shape), generator=gen)
    keep = torch.cat([u[:n_enc] < 1.0 - ENCODER_DROPOUT, u[n_enc:] < 1.0 - cfg.p_prenet_dropout])
    keep = to_device(keep.numpy(), device)
    return keep[:n_enc].view(enc_shape), keep[n_enc:].view(pre_shape)


def loss_fn(params, cfg: Tacotron2Config, batch: typing.Mapping[str, torch.Tensor],
            encoder_keep=None, prenet_keep=None, bn_stats: typing.Optional[list] = None,
            reduce=None):
    """(total, {"mel_pre", "mel_post", "gate"}).  Batch: ids [B, T],
    id_lengths [B], mels [B, S, M], mel_lengths [B] (tensors on the params'
    device).  With ``reduce`` (the data group's sum) this rank's shares of
    the global batch's losses."""
    mels, mel_lengths = batch["mels"], batch["mel_lengths"]
    s = mels.shape[1]
    frames = torch.arange(s, device=mels.device)[None, :]
    frame_mask = (frames < mel_lengths[:, None]).to(mels.dtype)
    pre, post, gates = t2_model.forward_teacher(
        params, cfg, batch["ids"], batch["id_lengths"], mels, train=True,
        encoder_keep=encoder_keep, prenet_keep=prenet_keep, bn_stats=bn_stats, reduce=reduce)
    count = frame_mask.sum() if reduce is None else reduce(frame_mask.sum())
    denom = torch.clamp(count, min=1.0) * mels.shape[-1]
    m = frame_mask[..., None]
    mel_pre = torch.sum(torch.square(pre - mels) * m) / denom
    mel_post = torch.sum(torch.square(post - mels) * m) / denom
    # the stop token: 1 from each row's last valid frame on, padding included
    gate_target = (frames >= (mel_lengths - 1)[:, None]).to(gates.dtype)
    if reduce is None:
        gate = F.binary_cross_entropy_with_logits(gates, gate_target)
    else:
        gate = F.binary_cross_entropy_with_logits(gates, gate_target, reduction="sum") / reduce(
            torch.tensor(float(gates.numel()), device=gates.device))
    return mel_pre + mel_post + gate, {"mel_pre": mel_pre, "mel_post": mel_post, "gate": gate}


@torch.no_grad()
def update_bn_running(bn_stats) -> None:
    """Each (bn params, batch mean, batch biased var, n) of a train-mode
    forward (``bn_stats`` of ``forward_teacher``) into its running
    ``mean``/``var``, in place, as
    ``torch.nn.BatchNorm1d(momentum=0.1)``: new = 0.9 old + 0.1 batch, the
    variance's batch value times n / (n - 1), n = B * T values a channel
    (a tensor: the global batch's, on a mesh)."""
    for p, mean, var, n in bn_stats:
        bessel = n / torch.clamp(n - 1, min=1) if torch.is_tensor(n) else n / max(n - 1, 1)
        p["mean"].mul_(1.0 - BN_MOMENTUM).add_(mean, alpha=BN_MOMENTUM)
        p["var"].mul_(1.0 - BN_MOMENTUM).add_(var * bessel, alpha=BN_MOMENTUM)


def make_train_step(cfg: Tacotron2Config, optimizer: Optimizer, mesh=None):
    """(state, batch, masks) -> (state, metrics): one update of the params
    and of the BatchNorms' running statistics, in place.  Batch: numpy
    arrays as ``Dataset.batches`` gives them, the global batch; masks:
    (encoder, prenet) keep masks of the global batch on the params' device,
    or None for no dropout.  Metrics are device scalars (on a mesh, this
    rank's shares).  On a ``TrainMesh`` each rank takes its rows and the
    gradients are summed over the data group before the clip; the model
    group, if any, repeats its data rank's work (JAX replicates the params
    over its model axis)."""
    reduce = data_sum(mesh)

    def train_step(state: Tacotron2TrainState, batch, masks=None):
        b = batch_to(local_rows(batch, mesh), state.params["embedding"].device)
        encoder_keep, prenet_keep = masks if masks is not None else (None, None)
        if masks is not None and mesh is not None and mesh.n_data > 1:
            rows = mesh.rows(next(iter(batch.values())).shape[0])
            encoder_keep = encoder_keep[:, rows[0] : rows[-1] + 1]
            prenet_keep = prenet_keep[:, rows[0] : rows[-1] + 1]
        zero_grads(state.opt_state)
        collected: list = []
        loss, parts = loss_fn(state.params, cfg, b, encoder_keep, prenet_keep, collected,
                              reduce=reduce)
        loss.backward()
        reduce_grads(state.opt_state, mesh)
        optimizer.update(state.opt_state)
        update_bn_running(collected)
        state.step += 1
        return state, {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}

    return train_step

