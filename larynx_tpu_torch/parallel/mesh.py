"""Device meshes: the serving mesh's positions and the training mesh's groups.

Counterpart of ``larynx_tpu/parallel/mesh.py``.  The JAX package builds one
``Mesh`` for both jobs; the port splits them along PyTorch's idiom:

* **Serving** is one process that drives every card, as the JAX serving
  mesh is one controller: a :class:`ServingMesh` is an ordered tuple of
  ``torch.device`` positions along a ``data`` axis.  The engine keeps a
  replica of the params on each device and launches each position's rows
  on that device's current stream from the one host thread
  (``runtime/engine.py``, ``parallel/time_shard.py``).  :func:`serving_mesh`
  discovers the cards as JAX's discovers its chips; a mesh whose positions
  repeat a device (``[cuda:0] * 4``, ``[cpu] * 4``) is allowed when the
  caller builds it, and runs every position's work on that device.
* **Training** is one process per device under ``torch.distributed``
  (torchrun's environment): a :class:`TrainMesh` is this rank's place in a
  ``(data, model)`` grid of ranks, rank r at data ``r // mp`` and model
  ``r % mp`` (JAX's grid order), with a process group along each axis.
  The model axis is tensor parallelism over the GlowTTS encoder's layers
  (:func:`glow_tp_axes`, JAX's ``glow_param_specs``); everything else is
  replicated.
"""

import os
import typing
from dataclasses import dataclass

import numpy as np
import torch

from larynx_tpu_torch.weights import glow_tp_axis, tp_merge, tp_slice


class ServingMesh:
    """An ordered tuple of device positions along one ``data`` axis.

    Position k holds rows ``[k * b / n, (k + 1) * b / n)`` of a batch of b
    rows (b a multiple of n).  Positions may repeat a device."""

    def __init__(self, devices: typing.Sequence[typing.Union[str, torch.device]]):
        # a CUDA device without an index is card 0, as torch places it
        self.positions = tuple(
            torch.device("cuda", 0) if torch.device(d).type == "cuda" and torch.device(d).index
            is None else torch.device(d) for d in devices)
        if not self.positions:
            raise ValueError("a serving mesh needs at least one position")

    @property
    def shape(self) -> typing.Dict[str, int]:
        return {"data": len(self.positions)}

    @property
    def devices(self) -> typing.Tuple[torch.device, ...]:
        """The distinct devices, in the order of their first position."""
        return tuple(dict.fromkeys(self.positions))

    def __len__(self) -> int:
        return len(self.positions)

    def __eq__(self, other) -> bool:
        return isinstance(other, ServingMesh) and self.positions == other.positions

    def __hash__(self) -> int:
        return hash(self.positions)

    def __repr__(self) -> str:
        return f"ServingMesh({[str(d) for d in self.positions]})"


def serving_mesh() -> typing.Optional[ServingMesh]:
    """A ``data`` mesh over the largest power of two of the CUDA devices
    (``larynx_tpu/parallel/mesh.py::serving_mesh``): None below two devices,
    on the CPU, or with ``LARYNX_TPU_MESH=off``.  It never repeats a device.
    Read at each call."""
    flag = os.environ.get("LARYNX_TPU_MESH", "auto").lower()
    if flag in ("off", "0", "none") or not torch.cuda.is_available():
        return None
    count = torch.cuda.device_count()
    if count < 2:
        return None
    n = 1 << (count.bit_length() - 1)
    return ServingMesh([torch.device("cuda", i) for i in range(n)])


def batch_rows(b: int, n: int) -> typing.List[np.ndarray]:
    """The row indices of each of n data shards of a b-row batch, in
    ``np.array_split`` order: the first ``b % n`` shards take one row more."""
    return np.array_split(np.arange(b), n)


@dataclass
class TrainMesh:
    """This rank's place in the training grid and its two process groups
    (None without ``torch.distributed``: one process, world 1)."""

    rank: int
    world: int
    model_parallel: int
    device: torch.device
    data_group: typing.Any = None
    model_group: typing.Any = None
    owns_group: bool = False  # make_mesh joined the process group itself

    @property
    def n_data(self) -> int:
        return self.world // self.model_parallel

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_parallel

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_parallel

    @property
    def distributed(self) -> bool:
        return self.data_group is not None

    def rows(self, b: int) -> np.ndarray:
        """This rank's rows of a b-row global batch."""
        return batch_rows(b, self.n_data)[self.data_rank]

    def close(self) -> None:
        """Leave the process group, if :func:`make_mesh` joined it."""
        if self.owns_group and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def world_size() -> int:
    """The number of training processes torchrun started (1 without it)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def is_rank0() -> bool:
    """Whether this process writes and logs: rank 0, or no torchrun."""
    return int(os.environ.get("RANK", "0")) == 0


def _train_device(device, local_rank: int) -> torch.device:
    """``device`` as named when it names an index or is not CUDA, else
    ``cuda:{local_rank}``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank)
    return device


def make_mesh(model_parallel: typing.Optional[int] = None, device="cuda",
              backend: typing.Optional[str] = None) -> TrainMesh:
    """The training mesh of this process (``larynx_tpu/parallel/mesh.py::
    make_mesh``).

    Under torchrun (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT`` in the environment) it joins the
    process group, with ``backend`` (default ``nccl`` for a CUDA device,
    ``gloo`` otherwise), and builds the data and model groups; without that
    environment it is world 1 with no group.  ``model_parallel`` None takes
    JAX's default: 2 when the world is even and above 1, else 1.  A model
    axis that does not divide the world exits naming both."""
    from larynx_tpu_torch.device import resolve_device

    env = os.environ
    distributed = "WORLD_SIZE" in env
    world = int(env.get("WORLD_SIZE", "1"))
    rank = int(env.get("RANK", "0"))
    local_rank = int(env.get("LOCAL_RANK", str(rank)))
    if model_parallel is None:
        model_parallel = 2 if world % 2 == 0 and world > 1 else 1
    if model_parallel < 1 or world % model_parallel:
        raise SystemExit(
            f"--model-parallel {model_parallel} must divide the world size {world} "
            "(launch N processes with python -m torch.distributed.run --nproc-per-node N)")
    device = resolve_device(_train_device(device, local_rank) if distributed else device)
    if not distributed:
        return TrainMesh(rank=0, world=1, model_parallel=1, device=device)

    dist = torch.distributed
    owns = not dist.is_initialized()
    if owns:
        if backend is None:
            backend = "nccl" if device.type == "cuda" else "gloo"
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, rank=rank, world_size=world)
    mp = model_parallel
    n_data = world // mp
    data_group = model_group = None
    # every rank creates every group, in one order
    for m in range(mp):
        group = dist.new_group([d * mp + m for d in range(n_data)])
        if rank % mp == m:
            data_group = group
    for d in range(n_data):
        group = dist.new_group([d * mp + m for m in range(mp)])
        if rank // mp == d:
            model_group = group
    return TrainMesh(rank=rank, world=world, model_parallel=mp, device=device,
                     data_group=data_group, model_group=model_group, owns_group=owns)


def glow_tp_axes(params) -> typing.Dict[typing.Tuple[str, ...], typing.Optional[int]]:
    """{leaf path: the axis it is split on over the model group, or None}
    for a GlowTTS tree in the port's layout: the counterpart of
    ``glow_param_specs``.  Column-parallel: ``conv1_w``/``conv1_b`` on the
    filter axis, ``q/k/v_w``/``_b`` on whole heads; row-parallel:
    ``conv2_w`` on the filter axis, ``o_w`` on its input axis; everything
    else (embeddings, norms, the row-parallel biases, relative-position
    embeddings, the duration predictor, the flow decoder) replicated."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out[path] = glow_tp_axis(path)

    walk(params, ())
    return out


def check_model_parallel(cfg, model_parallel: int) -> None:
    """Exit naming the sizes when the model axis does not divide the
    encoder's heads and filter channels."""
    if cfg.n_heads % model_parallel or cfg.filter_channels % model_parallel:
        raise SystemExit(
            f"--model-parallel {model_parallel} must divide n_heads ({cfg.n_heads}) and "
            f"filter_channels ({cfg.filter_channels})")


def shard_params(params, mesh: TrainMesh):
    """This model rank's slice of a full GlowTTS tree (port layout)."""
    if mesh.model_parallel == 1:
        return params
    return tp_slice(params, mesh.model_parallel, mesh.model_rank)


def gather_params(params, mesh: TrainMesh):
    """The full GlowTTS tree from every model rank's slice (an all-gather
    over the model group; each rank gets it), detached."""
    if mesh.model_parallel == 1:
        return params
    shards = [None] * mesh.model_parallel
    detached = _detach(params)
    torch.distributed.all_gather_object(shards, _to_cpu(detached), group=mesh.model_group)
    return tp_merge(shards)


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_detach(v) for v in tree]
    return tree.detach()


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()
