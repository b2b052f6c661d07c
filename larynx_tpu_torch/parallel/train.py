"""The GlowTTS training step, the optimizer of every trainer, the trainers'
metric history and the collectives of the training mesh.

Counterpart of ``larynx_tpu/parallel/train.py``.  On a ``TrainMesh``
(``parallel/mesh.py``: one process per device, torchrun's environment) the
step is data parallel over the ``data`` group and, for the GlowTTS encoder,
tensor parallel over the ``model`` group.  JAX's step is one global
program, so its losses are normalised over the whole batch; here each
rank takes its rows of the same global batch and keeps those semantics by
hand: every loss's numerator is local and its denominator summed over the
data group (:func:`global_sum`) before the division, each rank's loss is
its share of the global loss, and the gradients are summed over the data
group (:func:`all_reduce_grads`) before the clip, so that every rank clips
and updates the same vector.  The model axis carries two autograd
collectives (:class:`ModelAxis`): identity forward and all-reduce backward
before a column-parallel layer, all-reduce forward and identity backward
after a row-parallel one.

GlowTTS's optimizer is the JAX package's optax chain:
value clipping of every gradient element, then Adam (betas (0.9, 0.98),
eps 1e-9) at the Noam learning rate; Tacotron2's clips by the global norm
and decays the weights (optax's ``adamw``).  ``torch.optim.AdamW``'s update
is optax's; the learning rate of the k-th update (k from 0) is the schedule
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


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax's linear schedule: from ``init_value`` at 0 to ``end_value`` at
    ``transition_steps``, then held (held at ``init_value`` if
    ``transition_steps`` <= 0)."""

    def schedule(count: int) -> float:
        if transition_steps <= 0:
            return init_value
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def tree_leaves(tree) -> typing.List[torch.Tensor]:
    """The tensors of a parameter tree, in a fixed order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def trainable(tree, frozen: typing.Collection[str] = ()):
    """A copy of a parameter tree whose floating tensors are leaves that
    require grad, except those under a key in ``frozen`` (copied without
    grad: no optimizer sees them)."""
    if isinstance(tree, dict):
        return {k: v.detach().clone() if k in frozen else trainable(v, frozen)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [trainable(v, frozen) for v in tree]
    if tree.is_floating_point():
        return tree.detach().clone().requires_grad_(True)
    return tree


@dataclass
class OptState:
    adam: torch.optim.AdamW
    count: int = 0  # updates applied


@dataclass
class Optimizer:
    """optax.chain(clip, adamw(schedule, *betas, eps, weight_decay)):
    ``clip`` is ``"value"`` (optax.clip(grad_clip), every element into
    [-grad_clip, grad_clip]) or ``"global_norm"``
    (optax.clip_by_global_norm(grad_clip)); without a ``grad_clip``, no
    clip.  At ``weight_decay`` 0 the AdamW is optax's ``adam``.
    :meth:`init` binds it to params."""

    schedule: Schedule
    betas: typing.Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    grad_clip: typing.Optional[float] = None
    clip: str = "value"
    weight_decay: float = 0.0

    def init(self, params) -> OptState:
        if self.clip not in ("value", "global_norm"):
            raise ValueError(f"unknown clip {self.clip!r}")
        leaves = [p for p in tree_leaves(params) if p.requires_grad]
        return OptState(torch.optim.AdamW(leaves, lr=self.schedule(0), betas=self.betas,
                                          eps=self.eps, weight_decay=self.weight_decay))

    def update(self, state: OptState) -> None:
        """Apply one update from the params' ``.grad``; a param without a
        gradient (GlowTTS's stored ``weight_inv``) is left as it is."""
        params = [p for group in state.adam.param_groups for p in group["params"]]
        if self.grad_clip is not None and self.clip == "value":
            torch.nn.utils.clip_grad_value_(params, self.grad_clip)
        elif self.grad_clip is not None:
            clip_by_global_norm([p.grad for p in params if p.grad is not None], self.grad_clip)
        for group in state.adam.param_groups:
            group["lr"] = self.schedule(state.count)
        state.adam.step()
        state.count += 1


def clip_by_global_norm(grads: typing.List[torch.Tensor], max_norm: float) -> None:
    """optax's clip_by_global_norm in place, with no host sync: every
    gradient times max_norm / ||g|| where the global norm ||g|| >= max_norm
    (``clip_grad_norm_`` would add 1e-6 to the norm and scale below it too)."""
    if not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.where(norm < max_norm, 1.0, max_norm / norm))


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


def init_train_state(params, optimizer: Optimizer,
                     frozen: typing.Collection[str] = ()) -> TrainState:
    """Params (the port's layout, on their device) -> a state whose floating
    params, except those under a key in ``frozen``, are leaves that require
    grad, with a fresh optimizer."""
    params = trainable(params, frozen)
    return TrainState(params=params, opt_state=optimizer.init(params))


# -----------------------------------------------------------------------------
# the mesh's collectives


class _AllReduceSum(torch.autograd.Function):
    """A sum over a group that every rank uses: all-reduce forward, and
    all-reduce backward (the sum's gradient is every rank's)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        torch.distributed.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        torch.distributed.all_reduce(grad, group=ctx.group)
        return grad, None


class _CopyToModel(torch.autograd.Function):
    """Before a column-parallel layer: identity forward, all-reduce of the
    input's gradient backward (each model rank's slice contributes)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        torch.distributed.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """After a row-parallel layer: all-reduce of the partial outputs
    forward, the gradient as it is backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        torch.distributed.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over ``group``, differentiable (None: x itself)."""
    return x if group is None else _AllReduceSum.apply(x, group)


def data_sum(mesh) -> typing.Optional[typing.Callable[[torch.Tensor], torch.Tensor]]:
    """The differentiable sum over a mesh's data group, or None without one:
    what the losses, DDI and the BatchNorms take as ``reduce``."""
    if mesh is None or not mesh.distributed:
        return None
    return lambda x: global_sum(x, mesh.data_group)


class ModelAxis:
    """The model group's two collectives, for the encoder's tensor-parallel
    layers (``models/glow_tts/encoder.py``)."""

    def __init__(self, group, size: int):
        self.group, self.size = group, size

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromModel.apply(x, self.group)


def model_axis(mesh) -> typing.Optional[ModelAxis]:
    if mesh is None or mesh.model_parallel == 1:
        return None
    return ModelAxis(mesh.model_group, mesh.model_parallel)


def all_reduce_grads(params: typing.Sequence[torch.Tensor], group) -> None:
    """Sum every param's ``.grad`` over ``group`` in place, as one flat
    all-reduce."""
    grads = [p.grad for p in params if p.grad is not None]
    if group is None or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    torch.distributed.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset : offset + g.numel()].view_as(g))
        offset += g.numel()


def reduce_grads(opt_state: OptState, mesh) -> None:
    """The data group's sum of the optimizer's params' gradients."""
    if mesh is not None and mesh.distributed:
        all_reduce_grads([p for g in opt_state.adam.param_groups for p in g["params"]],
                         mesh.data_group)


def local_rows(batch: typing.Mapping[str, typing.Any], mesh) -> typing.Dict[str, typing.Any]:
    """This rank's rows of a global batch (numpy or tensors)."""
    if mesh is None or mesh.n_data == 1:
        return dict(batch)
    b = next(iter(batch.values())).shape[0]
    rows = mesh.rows(b)
    return {k: v[rows[0] : rows[-1] + 1] if len(rows) else v[:0] for k, v in batch.items()}


LOG_EVERY = 10  # steps between the trainers' log lines


class MetricHistory:
    """Every step's metrics, as host floats in :attr:`steps`.

    A step's metrics (device scalars) wait in a pending block until
    :meth:`flush`, which the trainers call at each log point (every
    ``LOG_EVERY`` steps, where they read the metrics anyway), at the end of a
    run and at an interrupt: one device-to-host copy per block, and never
    more than ``LOG_EVERY`` steps of metrics on the device.  With a data
    ``group`` a step's metrics are this rank's shares of the global ones and
    the flush sums the block over the group, in one all-reduce: there is no
    collective per step."""

    def __init__(self, group=None):
        self.steps: typing.List[typing.Dict[str, float]] = []
        self._pending: typing.List[typing.Mapping[str, torch.Tensor]] = []
        self._group = group

    def append(self, metrics: typing.Mapping[str, torch.Tensor]) -> None:
        self._pending.append(metrics)

    def flush(self) -> typing.Optional[typing.Dict[str, float]]:
        """Move the pending steps to the host; returns the last step's
        metrics (None if none were pending)."""
        if not self._pending:
            return None
        keys = list(self._pending[0])
        block = torch.stack([m[k].detach().reshape(()) for m in self._pending for k in keys])
        if self._group is not None:
            torch.distributed.all_reduce(block, group=self._group)
        values = block.tolist()
        self.steps.extend(dict(zip(keys, values[i:i + len(keys)]))
                          for i in range(0, len(values), len(keys)))
        self._pending = []
        return self.steps[-1]


def batch_to(batch: typing.Mapping[str, np.ndarray], device) -> typing.Dict[str, torch.Tensor]:
    """A batch of numpy arrays on ``device``, integers as int64."""
    return {k: to_device(v if v.dtype.kind == "f" else v.astype(np.int64), device)
            for k, v in batch.items()}


def zero_grads(opt_state: OptState) -> None:
    for group in opt_state.adam.param_groups:
        for p in group["params"]:
            p.grad = None


def make_train_step(cfg: GlowTTSConfig, optimizer: Optimizer, mesh=None):
    """(state, batch) -> (state, metrics): one update of the params in
    place.  Batch: numpy ids [B, T], id_lengths [B], mels [B, M, C],
    mel_lengths [B], the global batch; metrics are device scalars (on a
    mesh, this rank's shares).  On a ``TrainMesh`` each rank takes its rows,
    the losses are normalised over the global batch, the gradients summed
    over the data group before the clip, and the encoder runs tensor
    parallel over the model group on params from ``mesh.shard_params``."""
    reduce, tp = data_sum(mesh), model_axis(mesh)
    first = mesh is None or mesh.data_rank == 0

    def train_step(state: TrainState, batch):
        b = batch_to(local_rows(batch, mesh), state.params["encoder"]["emb"].device)
        zero_grads(state.opt_state)
        loss, metrics = training_forward(state.params, cfg, b["ids"], b["id_lengths"], b["mels"],
                                         b["mel_lengths"], reduce=reduce, first=first, tp=tp)
        loss.backward()
        reduce_grads(state.opt_state, mesh)
        optimizer.update(state.opt_state)
        state.step += 1
        return state, metrics

    return train_step
