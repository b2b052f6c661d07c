"""The GlowTTS training step and the optimizers of both trainers, on one
device.

Counterpart of ``larynx_tpu/parallel/train.py`` without the mesh: data
parallelism and the encoder's tensor parallelism wait for ROADMAP's
multi-GPU item.  The optimizer is the JAX package's optax chain: value
clipping of every gradient element, then Adam (betas (0.9, 0.98), eps
1e-9) at the Noam learning rate.  ``torch.optim.Adam``'s update is
optax's; the learning rate of the k-th update (k from 0) is the schedule
at k, as optax reads its count before it increments it.
"""

import typing
from dataclasses import dataclass

import numpy as np
import torch

from larynx_tpu_torch.device import to_device
from larynx_tpu_torch.models.glow_tts.config import GlowTTSConfig
from larynx_tpu_torch.models.glow_tts.training import training_forward

Schedule = typing.Callable[[int], float]


def noam_schedule(d_model: int, warmup_steps: int = 4000, scale: float = 1.0) -> Schedule:
    """lr(k) = scale * d^-0.5 * min(k^-0.5, k * warmup^-1.5) at k >= 1, in
    float32 as the JAX schedule."""

    def schedule(count: int) -> float:
        step = np.float32(max(count, 1))
        return float(np.float32(scale * d_model**-0.5)
                     * min(step ** np.float32(-0.5), step * np.float32(warmup_steps**-1.5)))

    return schedule


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float) -> Schedule:
    """optax's continuous exponential decay: lr(k) = init * decay^(k / every)."""
    return lambda count: init_value * decay_rate ** (count / transition_steps)


def tree_leaves(tree) -> typing.List[torch.Tensor]:
    """The tensors of a parameter tree, in a fixed order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def trainable(tree):
    """A copy of a parameter tree whose floating tensors are leaves that
    require grad."""
    if isinstance(tree, dict):
        return {k: trainable(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [trainable(v) for v in tree]
    if tree.is_floating_point():
        return tree.detach().clone().requires_grad_(True)
    return tree


@dataclass
class OptState:
    adam: torch.optim.Adam
    count: int = 0  # updates applied


@dataclass
class Optimizer:
    """optax.chain(clip(grad_clip), adam(schedule, *betas, eps)); without a
    ``grad_clip``, the Adam alone.  :meth:`init` binds it to params."""

    schedule: Schedule
    betas: typing.Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    grad_clip: typing.Optional[float] = None

    def init(self, params) -> OptState:
        leaves = [p for p in tree_leaves(params) if p.requires_grad]
        return OptState(torch.optim.Adam(leaves, lr=self.schedule(0), betas=self.betas,
                                         eps=self.eps))

    def update(self, state: OptState) -> None:
        """Apply one update from the params' ``.grad``; a param without a
        gradient (GlowTTS's stored ``weight_inv``) is left as it is."""
        params = [p for group in state.adam.param_groups for p in group["params"]]
        if self.grad_clip is not None:
            torch.nn.utils.clip_grad_value_(params, self.grad_clip)
        for group in state.adam.param_groups:
            group["lr"] = self.schedule(state.count)
        state.adam.step()
        state.count += 1


def make_optimizer(
    cfg: GlowTTSConfig,
    learning_rate_scale: float = 1.0,
    warmup_steps: int = 4000,
    grad_clip: float = 5.0,
    betas: typing.Tuple[float, float] = (0.9, 0.98),
    eps: float = 1e-9,
) -> Optimizer:
    return Optimizer(noam_schedule(cfg.hidden_channels, warmup_steps, learning_rate_scale),
                     betas=betas, eps=eps, grad_clip=grad_clip)


@dataclass
class TrainState:
    params: typing.Any
    opt_state: OptState
    step: int = 0


def init_train_state(params, optimizer: Optimizer) -> TrainState:
    """Params (the port's layout, on their device) -> a state whose floating
    params are leaves that require grad, with a fresh optimizer."""
    params = trainable(params)
    return TrainState(params=params, opt_state=optimizer.init(params))


def batch_to(batch: typing.Mapping[str, np.ndarray], device) -> typing.Dict[str, torch.Tensor]:
    """A batch of numpy arrays on ``device``, integers as int64."""
    return {k: to_device(v if v.dtype.kind == "f" else v.astype(np.int64), device)
            for k, v in batch.items()}


def zero_grads(opt_state: OptState) -> None:
    for group in opt_state.adam.param_groups:
        for p in group["params"]:
            p.grad = None


def make_train_step(cfg: GlowTTSConfig, optimizer: Optimizer):
    """(state, batch) -> (state, metrics): one update of the params in
    place.  Batch: numpy ids [B, T], id_lengths [B], mels [B, M, C],
    mel_lengths [B]; metrics are device scalars."""

    def train_step(state: TrainState, batch):
        b = batch_to(batch, state.params["encoder"]["emb"].device)
        zero_grads(state.opt_state)
        loss, metrics = training_forward(state.params, cfg, b["ids"], b["id_lengths"], b["mels"],
                                         b["mel_lengths"])
        loss.backward()
        optimizer.update(state.opt_state)
        state.step += 1
        return state, metrics

    return train_step
