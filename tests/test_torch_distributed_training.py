"""The training mesh: data- and tensor-parallel steps over gloo on the CPU.

One ``torch.multiprocessing`` spawn a world size runs every case of that
world (world 2: GlowTTS data parallel with DDI, GlowTTS with
``model_parallel`` 2, HiFi-GAN, Tacotron2; world 4: GlowTTS on the 2 x 2
grid), each rank writing its gradients, metrics and state to a file; the
tests hold them against the port's world-1 step on the same global batch,
run here, and against JAX's single-device gradients.  The batches are
ragged, and GlowTTS's 5 rows and Tacotron2's 3 split unevenly (3 + 2,
2 + 1), so a step that averaged the ranks' means would fail.

Tolerances:

* world N against world 1, float32: the same sums in another order (each
  rank's partial sums, then the all-reduce; the model ranks' partial
  products).  GlowTTS: every gradient within 1e-5 of its leaf's scale, the
  scale floored at 1e-4 of the net's largest gradient (seen: 2.6e-6).
  HiFi-GAN and Tacotron2: 1e-4, the bound that their single-device float32
  step holds against float64 (each side is ~3e-5 from it: the log-mel L1's
  signs and the long conv sums; the recurrence), the floor 1e-2 for
  Tacotron2, whose conv biases before a BatchNorm have a true gradient of 0
  and hold float32 noise alone.  Metrics and DDI within 1e-5 relative, the
  BatchNorm running statistics within 1e-6 of their scale floored at 1 (the
  activations are O(1): a mean near 0 keeps their absolute rounding).
* against JAX's single-device gradient: the existing tests' bounds
  (``test_torch_glow_tts_training.py``: float32 JAX, 1e-4 of scale;
  ``test_torch_hifi_gan_training.py`` and ``test_torch_tacotron2_training.py``:
  float64 JAX, 1e-4 of scale).
* ``gather_params`` of the shards: equal to the full tree, element for
  element.

The CLI cases run ``python -m torch.distributed.run --nproc-per-node 2``
on ``--device cpu`` (gloo): GlowTTS with ``--model-parallel 2`` and
HiFi-GAN data parallel; rank 0 alone writes and logs, and the written
dirs load into ``text_to_speech(device="cpu")``.
"""

import dataclasses
import json
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

import larynx_tpu_torch
from larynx_tpu_torch.audio import AudioSettings
from larynx_tpu_torch.models.glow_tts import training as gtr
from larynx_tpu_torch.models.glow_tts.config import GlowTTSConfig
from larynx_tpu_torch.models.hifi_gan import training as htr
from larynx_tpu_torch.models.hifi_gan.config import HiFiGanConfig
from larynx_tpu_torch.models.tacotron2 import training as ttr
from larynx_tpu_torch.models.tacotron2.config import Tacotron2Config
from larynx_tpu_torch.parallel import mesh as pmesh
from larynx_tpu_torch.parallel import train as ptrain
from larynx_tpu_torch.weights import init_params, params_from_jax, tp_merge

REPO = Path(__file__).resolve().parent.parent
# test_torch_glow_tts_training.py's SMALL, test_torch_hifi_gan_training.py's SMALL
GLOW = dict(num_symbols=46, hidden_channels=64, filter_channels=128, filter_channels_dp=64,
            mel_channels=80, n_layers_enc=2, n_blocks_dec=2, n_block_layers=2, window_size=4,
            mean_only=True, prenet=True)
HIFI = dict(resblock="2", upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
            upsample_initial_channel=32, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 2),))
HIFI_FRAMES = 8
# the CLI cases' dirs, as test_torch_train_cli.py's
VOICE = "en-us_trained_dist-glow_tts"
VOCODER = "hifi_gan/trained_dist"
TEXT = "A voice is born. Testing one two three."
BIG_CLIP = 1e9  # the value clip on, never binding: the gradients are compared as computed
SPAWN_TIMEOUT = 600  # seconds for a spawned world, as for a torchrun CLI case


# -----------------------------------------------------------------------------
# problems, built the same way here and in the spawned ranks


def _glow_batch(b=5, t=12, m=48, seed=0):
    rng = np.random.default_rng(seed)
    id_lengths = np.array([12, 9, 11, 7, 10][:b], np.int32)
    ids = np.where(np.arange(t)[None] < id_lengths[:, None],
                   rng.integers(1, 46, (b, t)), 0).astype(np.int32)
    mels = (rng.standard_normal((b, m, 80)) * 0.5).astype(np.float32)
    mel_lengths = np.array([48, 37, 44, 30, 40][:b], np.int32)
    return {"ids": ids, "id_lengths": id_lengths, "mels": mels, "mel_lengths": mel_lengths}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in _leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def _grads(params):
    """A tree of the params' gradients (zeros where a leaf has none), numpy."""
    if isinstance(params, dict):
        return {k: _grads(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_grads(v) for v in params]
    g = params.grad
    return (np.zeros(params.shape, np.float32) if g is None else g.detach().numpy().copy())


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.detach().numpy().copy()


def _glow_step(params, batch, mesh, ddi: bool):
    """(DDI'd actnorm, gradients, flushed metrics, params after DDI) of one
    GlowTTS step on the global batch."""
    cfg = GlowTTSConfig(**GLOW)
    tparams = params_from_jax(params, "glow_tts")
    actnorm = None
    if ddi:
        local = ptrain.local_rows(batch, mesh)
        tparams = gtr.actnorm_ddi_init(tparams, cfg, torch.from_numpy(local["mels"]),
                                       torch.from_numpy(local["mel_lengths"]).long(),
                                       reduce=ptrain.data_sum(mesh))
        actnorm = _numpy(tparams["decoder"]["actnorm"])
    opt = ptrain.make_optimizer(cfg, warmup_steps=1, grad_clip=BIG_CLIP)
    sharded = tparams if mesh is None else pmesh.shard_params(tparams, mesh)
    state = ptrain.init_train_state(sharded, opt)
    history = ptrain.MetricHistory(None if mesh is None else mesh.data_group)
    _, metrics = ptrain.make_train_step(cfg, opt, mesh)(state, batch)
    history.append(metrics)
    history.flush()
    out = {"actnorm": actnorm, "grads": _grads(state.params), "metrics": history.steps[0]}
    if mesh is not None and mesh.model_parallel > 1:
        out["gathered"] = _numpy(pmesh.gather_params(pmesh.shard_params(tparams, mesh), mesh))
        out["full"] = _numpy(tparams)
        out["axes"] = pmesh.glow_tp_axes(sharded)
    return out


def _hifi_step(gen, dis, audio, mels, mesh):
    """The gradients of both updates of one GAN step (learning rate 0: the
    generator's objective sees the discriminators the world-1 step sees)."""
    opt = ptrain.Optimizer(lambda k: 0.0, betas=(0.8, 0.99))
    gen_t = ptrain.trainable(params_from_jax(gen, "hifi_gan"))
    dis_t = ptrain.trainable(params_from_jax(dis, "discriminators"))
    state = htr.GanTrainState(gen_t, dis_t, opt.init(gen_t), opt.init(dis_t))
    step = htr.make_gan_train_step(HiFiGanConfig(**HIFI), AudioSettings(), opt, opt, mesh=mesh)
    d_grads = {}

    real_update = opt.update

    def update(opt_state):  # the discriminators' gradients, before the generator's step
        if opt_state is state.disc_opt:
            d_grads.update(_grads(state.disc_params))
        real_update(opt_state)

    opt.update = update
    history = ptrain.MetricHistory(None if mesh is None else mesh.data_group)
    history.append(step(state, {"audio": torch.from_numpy(audio), "mels": torch.from_numpy(mels)})[1])
    history.flush()
    return {"d_grads": d_grads, "g_grads": _grads(state.gen_params), "metrics": history.steps[0]}


def _t2_step(cfg_dict, params, batch, masks, mesh):
    """Gradients, metrics and the BatchNorms' running statistics after one
    Tacotron2 step (learning rate 0, no clip)."""
    opt = ptrain.Optimizer(lambda k: 0.0)
    state = ttr.init_train_state(params_from_jax(params, "tacotron2"), opt)
    history = ptrain.MetricHistory(None if mesh is None else mesh.data_group)
    step = ttr.make_train_step(Tacotron2Config(**cfg_dict), opt, mesh)
    history.append(step(state, batch, tuple(torch.from_numpy(m) for m in masks))[1])
    history.flush()
    running = {path: leaf.numpy().copy() for path, leaf in _leaves(state.params)
               if path.endswith(("/mean", "/var"))}
    return {"grads": _grads(state.params), "metrics": history.steps[0], "running": running}


def _worker(rank, world, port, problems, out_dir):
    """One rank of a spawned world: every case of ``problems``, its results
    pickled to ``out_dir/rank{rank}.pkl``."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    out = {}
    dp = pmesh.make_mesh(1, device="cpu")
    tp = pmesh.make_mesh(2, device="cpu")
    assert (dp.n_data, tp.model_parallel, tp.n_data) == (world, 2, world // 2)
    if "glow" in problems:
        params, batch = problems["glow"]
        if world == 2:
            out["glow_dp"] = _glow_step(params, batch, dp, ddi=True)
        out["glow_tp"] = _glow_step(params, batch, tp, ddi=True)
    if "hifi" in problems:
        out["hifi"] = _hifi_step(*problems["hifi"], dp)
    if "t2" in problems:
        out["t2"] = _t2_step(*problems["t2"], dp)
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dp.close()  # the first mesh joined the group: it leaves it


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world, problems, out_dir):
    """Every rank of a world run to its end, or the test fails at
    ``SPAWN_TIMEOUT`` with the ranks still running terminated: a rank that
    hangs in a collective fails the test instead of holding its worker."""
    context = tmp.spawn(_worker, args=(world, _free_port(), problems, str(out_dir)),
                        nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not context.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in context.processes:
                if proc.is_alive():
                    proc.terminate()
            for proc in context.processes:
                proc.join(timeout=10)
                if proc.is_alive():
                    proc.kill()
            pytest.fail(f"the world of {world} ranks did not finish in {SPAWN_TIMEOUT} s")
    return [pickle.loads((Path(out_dir) / f"rank{r}.pkl").read_bytes()) for r in range(world)]


# -----------------------------------------------------------------------------
# fixtures: the problems (JAX's inits), the two spawns


@pytest.fixture(scope="module")
def problems():
    import jax

    from larynx_tpu.models.glow_tts import init_params as j_glow_init
    from larynx_tpu.models.glow_tts.config import GlowTTSConfig as JGlowConfig
    from larynx_tpu.models.hifi_gan import init_params as j_hifi_init
    from larynx_tpu.models.hifi_gan.config import HiFiGanConfig as JHiFiConfig
    from larynx_tpu.models.tacotron2 import training as jtr

    from test_tacotron2 import CFG as T2_BASE

    glow = jax.tree.map(np.asarray, j_glow_init(jax.random.PRNGKey(0), JGlowConfig(**GLOW)))
    cp = glow["decoder"]["coupling"]
    cp["end_w"] = (np.random.default_rng(0).standard_normal(cp["end_w"].shape)
                   * 0.05).astype(np.float32)
    gen = jax.tree.map(np.asarray, j_hifi_init(jax.random.PRNGKey(0), JHiFiConfig(**HIFI)))
    dis = init_params(torch.Generator().manual_seed(1), "discriminators")
    rng = np.random.default_rng(4)
    t = np.arange(HIFI_FRAMES * 256) / 22050.0
    audio = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 300, (2, 1)) * t)
             + 0.05 * rng.standard_normal((2, t.size))).astype(np.float32)
    mels = rng.standard_normal((2, HIFI_FRAMES, 80)).astype(np.float32)

    # test_torch_tacotron2_training.py's problem: 3 ragged rows, JAX's masks
    t2_cfg = dataclasses.replace(T2_BASE, p_prenet_dropout=0.5)
    t2_params = jax.tree.map(np.asarray, jtr.init_params(jax.random.PRNGKey(0), t2_cfg))
    rng = np.random.default_rng(0)
    b, t_ids, s = 3, 10, 12
    id_lengths = np.array([10, 7, 4], np.int32)
    ids = np.where(np.arange(t_ids)[None] < id_lengths[:, None],
                   rng.integers(1, t2_cfg.num_symbols, (b, t_ids)), 0).astype(np.int32)
    mel_lengths = np.array([12, 9, 5], np.int32)
    t2_mels = rng.standard_normal((b, s, t2_cfg.mel_channels)).astype(np.float32)
    t2_mels *= (np.arange(s)[None, :, None] < mel_lengths[:, None, None])
    key = jax.random.PRNGKey(3)
    enc_key, dec_key = jax.random.fold_in(key, 0), jax.random.fold_in(key, 1)
    enc = np.stack([np.asarray(jax.random.bernoulli(jax.random.fold_in(enc_key, i), 0.5,
                                                    (b, t_ids, t2_cfg.encoder_embedding_dim)))
                    for i in range(t2_cfg.encoder_n_convolutions)])
    pre = np.stack([np.asarray(jax.random.bernoulli(jax.random.fold_in(dec_key, i),
                                                    1.0 - t2_cfg.p_prenet_dropout,
                                                    (b, s, t2_cfg.prenet_dim)))
                    for i in range(2)])
    t2_batch = {"ids": ids, "id_lengths": id_lengths, "mels": t2_mels,
                "mel_lengths": mel_lengths}
    return {
        "glow": (glow, _glow_batch()),
        "hifi": (gen, dis, audio, mels),
        "t2": (dataclasses.asdict(t2_cfg), t2_params, t2_batch, (enc, pre)),
        "t2_jax": (t2_cfg, key),
    }


@pytest.fixture(scope="module")
def world2(problems, tmp_path_factory):
    spawned = {k: v for k, v in problems.items() if k != "t2_jax"}
    return _spawn(2, spawned, tmp_path_factory.mktemp("world2"))


@pytest.fixture(scope="module")
def world4(problems, tmp_path_factory):
    return _spawn(4, {"glow": problems["glow"]}, tmp_path_factory.mktemp("world4"))


@pytest.fixture(scope="module")
def world1(problems):
    glow, batch = problems["glow"]
    cfg_dict, t2_params, t2_batch, masks = problems["t2"]
    return {"glow": _glow_step(glow, batch, None, ddi=True),
            "hifi": _hifi_step(*problems["hifi"], None),
            "t2": _t2_step(cfg_dict, t2_params, t2_batch, masks, None)}


def _close_trees(got, want, rel=1e-5, floor_share=1e-4, what=""):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    floor = floor_share * max(np.abs(v).max() for v in want.values())
    for path, ref in want.items():
        err = np.abs(got[path] - ref).max()
        assert err <= rel * max(np.abs(ref).max(), floor), (what, path, err)


def _close_metrics(got, want, rel=1e-5):
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= rel * max(abs(want[k]), 1e-30), (k, got[k], want[k])


# -----------------------------------------------------------------------------
# GlowTTS


def test_glow_tts_data_parallel_matches_world_1(world2, world1):
    """Ragged rows, 3 + 2 over two ranks, DDI from the global sums: both
    ranks hold the world-1 step's summed gradients and DDI, the flushed
    metrics the global losses."""
    want = world1["glow"]
    for rank in world2:
        got = rank["glow_dp"]
        _close_trees(got["grads"], want["grads"], what="grads")
        _close_trees(got["actnorm"], want["actnorm"], floor_share=0.0, what="ddi")
        _close_metrics(got["metrics"], want["metrics"])


@pytest.mark.parametrize("world", [2, 4], ids=["1x2", "2x2"])
def test_glow_tts_tensor_parallel_matches_world_1(world, world2, world4, world1):
    """``model_parallel`` 2: each model rank's sharded gradients, merged,
    and every replicated leaf's, are the world-1 step's; the 2 x 2 grid
    also splits the rows."""
    ranks = world2 if world == 2 else world4
    for d in range(world // 2):
        pair = ranks[2 * d : 2 * d + 2]
        merged = tp_merge([_as_tensors(r["glow_tp"]["grads"]) for r in pair])
        _close_trees(_numpy(merged), world1["glow"]["grads"], what=f"data rank {d}")
        _close_metrics(pair[0]["glow_tp"]["metrics"], world1["glow"]["metrics"])
        _close_trees(pair[1]["glow_tp"]["actnorm"], world1["glow"]["actnorm"], floor_share=0.0)


def _as_tensors(tree):
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_tensors(v) for v in tree]
    return torch.from_numpy(np.asarray(tree))


def test_gather_params_round_trips(world2, world4):
    """``gather_params`` of every model rank's ``shard_params`` slice is the
    single-device tree, element for element, on every rank."""
    for rank in world2 + world4:
        got, want = dict(_leaves(rank["glow_tp"]["gathered"])), dict(
            _leaves(rank["glow_tp"]["full"]))
        assert sorted(got) == sorted(want)
        for path in want:
            np.testing.assert_array_equal(got[path], want[path], err_msg=path)


def test_glow_tp_axes_match_glow_param_specs(problems, world2):
    """``glow_tp_axes`` names, leaf by leaf, the axis that JAX's
    ``glow_param_specs`` shards over ``model``, moved to the port's layout,
    and the shards hold that axis halved."""
    import jax

    from larynx_tpu.parallel.mesh import glow_param_specs

    glow, _ = problems["glow"]
    specs = glow_param_specs(glow)
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))[0]
    full = params_from_jax(glow, "glow_tts")
    axes = pmesh.glow_tp_axes(full)
    assert len(flat) == len(axes)
    for path, spec in flat:
        keys = tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        jax_axis = next((i for i, a in enumerate(spec) if a == "model"), None)
        port_axis = axes[keys]
        if jax_axis is None:
            assert port_axis is None, keys
            continue
        leaf = full
        for k in keys:
            leaf = leaf[int(k)] if isinstance(leaf, list) else leaf[k]
        # the native [L, k, Ci, Co] / [L, Ci, Co] against the port's
        # [L, Co, Ci, k] / [L, Co, Ci]: the split dimension is the same size
        native = glow
        for k in keys:
            native = native[int(k)] if isinstance(native, list) else native[k]
        assert leaf.shape[port_axis] == native.shape[jax_axis], keys
        sharded = dict(world2[0]["glow_tp"]["axes"])
        assert sharded[keys] == port_axis


def test_glow_tts_gradients_match_jax(problems, world2):
    """The world-2 data-parallel step's gradients against JAX's
    single-device ``value_and_grad`` of the whole batch (after the same DDI)."""
    import jax
    import jax.numpy as jnp

    from larynx_tpu.models.glow_tts import training as jtr
    from larynx_tpu.models.glow_tts.config import GlowTTSConfig as JGlowConfig
    from larynx_tpu_torch.weights import params_to_jax

    glow, batch = problems["glow"]
    jcfg = JGlowConfig(**GLOW)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jtr.actnorm_ddi_init(glow, jcfg, jb["mels"], jb["mel_lengths"])
    params = jax.tree.map(np.asarray, params)
    params["decoder"]["actnorm"] = params_to_jax(
        {"decoder": {"actnorm": _as_tensors(world2[0]["glow_dp"]["actnorm"])}},
        "glow_tts")["decoder"]["actnorm"]

    def loss_fn(p):
        return jtr.training_forward(p, jcfg, jb["ids"], jb["id_lengths"], jb["mels"],
                                    jb["mel_lengths"])

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    want = _numpy(params_from_jax(jax.tree.map(np.asarray, grads), "glow_tts"))
    got = world2[0]["glow_dp"]["grads"]
    # the forward flow never reads weight_inv: zero on both sides
    _close_trees(got, want, rel=1e-4)
    _close_metrics(world2[0]["glow_dp"]["metrics"],
                   {k: float(v) for k, v in metrics.items()}, rel=1e-5)


# -----------------------------------------------------------------------------
# HiFi-GAN and Tacotron2


def test_hifi_gan_data_parallel_matches_world_1(world2, world1):
    want = world1["hifi"]
    for rank in world2:
        _close_trees(rank["hifi"]["d_grads"], want["d_grads"], rel=1e-4, what="D")
        _close_trees(rank["hifi"]["g_grads"], want["g_grads"], rel=1e-4, what="G")
        _close_metrics(rank["hifi"]["metrics"], want["metrics"])


def test_hifi_gan_gradients_match_jax(problems, world2):
    """Both updates' gradients of the world-2 step against JAX's objectives
    in float64 (``test_torch_hifi_gan_training.py``'s bound)."""
    import jax

    from larynx_tpu.audio import mel_basis as j_mel_basis
    from larynx_tpu.models.hifi_gan import model as jgen
    from larynx_tpu.models.hifi_gan.config import HiFiGanConfig as JHiFiConfig

    from test_torch_hifi_gan_training import _jax_d_loss, _jax_g_loss

    gen, dis, audio, mels = problems["hifi"]
    f64 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float64), tree)  # noqa: E731
    with jax.enable_x64():
        fake = jax.jit(jgen.generator, static_argnums=1)(f64(gen), JHiFiConfig(**HIFI),
                                                           f64(mels))
        d_grads = jax.jit(jax.grad(_jax_d_loss))(f64(dis), f64(audio), fake)
        basis = j_mel_basis(22050, 1024, 80, 0.0, 8000.0, dtype=np.float64)
        g_grads = jax.jit(jax.grad(lambda *a: _jax_g_loss(*a)[0]))(
            f64(gen), f64(dis), f64(audio), f64(mels), basis)
    for got, want, kind in ((world2[0]["hifi"]["d_grads"], d_grads, "discriminators"),
                            (world2[0]["hifi"]["g_grads"], g_grads, "hifi_gan")):
        want = _numpy(params_from_jax(jax.tree.map(np.asarray, want), kind))
        _close_trees(got, want, rel=1e-4, floor_share=0.0, what=kind)


def test_tacotron2_data_parallel_matches_world_1(world2, world1):
    """3 ragged rows over 2 ranks (2 + 1): the gradients, the global mel and
    gate losses, and the running statistics of the global batch."""
    want = world1["t2"]
    for rank in world2:
        got = rank["t2"]
        _close_trees(got["grads"], want["grads"], rel=1e-4, floor_share=1e-2)
        _close_metrics(got["metrics"], want["metrics"])
        for path, ref in want["running"].items():
            err = np.abs(got["running"][path] - ref).max()
            assert err <= 1e-6 * max(np.abs(ref).max(), 1.0), (path, err)
    # the statistics moved off the init's 0 and 1
    assert any(np.abs(v).max() > 1e-3 for p, v in want["running"].items() if p.endswith("mean"))


def test_tacotron2_gradients_match_jax(problems, world2, monkeypatch):
    """The world-2 step's gradients against ``jax.grad`` in float64 under
    JAX's own masks (``test_torch_tacotron2_training.py``'s bound)."""
    import jax

    from larynx_tpu.models.tacotron2 import training as jtr

    _cfg, params, batch, _masks = problems["t2"]
    j_cfg, key = problems["t2_jax"]
    f64 = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    jb = {k: np.asarray(v, np.float64) if v.dtype.kind == "f" else v for k, v in batch.items()}
    bernoulli = jax.random.bernoulli
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda k, p, shape: bernoulli(k, np.float32(p), shape))
    with jax.enable_x64():
        grads = jax.jit(jax.grad(lambda p: jtr.loss_fn(p, j_cfg, jb, key)[0]))(f64)
    want = _numpy(params_from_jax(jax.tree.map(np.asarray, grads), "tacotron2"))
    got = world2[0]["t2"]["grads"]
    _close_trees(got, want, rel=1e-4, floor_share=1e-2)


# -----------------------------------------------------------------------------
# exits


def test_model_parallel_must_divide_the_world_and_the_encoder(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="world size 2"):
        pmesh.make_mesh(3, device="cpu")
    with pytest.raises(SystemExit, match=r"n_heads \(2\) and filter_channels \(128\)"):
        pmesh.check_model_parallel(GlowTTSConfig(**GLOW), 4)
    pmesh.check_model_parallel(GlowTTSConfig(**GLOW), 2)
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(SystemExit, match="world size 1"):
        pmesh.make_mesh(2, device="cpu")
    assert pmesh.make_mesh(None, device="cpu").world == 1


def test_vocoder_trainer_exits(monkeypatch):
    """WaveGlow trains on one device; HiFi-GAN's batch must split over the
    ranks.  Both exit before any group is joined."""
    from larynx_tpu_torch import train_vocoder

    monkeypatch.setenv("WORLD_SIZE", "2")
    argv = ["--wav-dir", "/nonexistent", "--out-dir", "/nonexistent/v", "--device", "cpu"]
    with pytest.raises(SystemExit, match="one device.*world size 2"):
        train_vocoder.main(argv + ["--family", "waveglow"])
    with pytest.raises(SystemExit, match="--batch-size 3 does not split over world size 2"):
        train_vocoder.main(argv + ["--batch-size", "3"])
    assert not torch.distributed.is_initialized()


def test_batch_rows_split_as_array_split():
    assert [list(r) for r in pmesh.batch_rows(5, 2)] == [[0, 1, 2], [3, 4]]
    assert [list(r) for r in pmesh.batch_rows(3, 4)] == [[0], [1], [2], []]
    mesh = pmesh.TrainMesh(rank=3, world=4, model_parallel=2, device=torch.device("cpu"))
    assert (mesh.n_data, mesh.data_rank, mesh.model_rank) == (2, 1, 1)
    assert list(mesh.rows(5)) == [3, 4]
    batch = {"x": np.arange(10).reshape(5, 2)}
    assert ptrain.local_rows(batch, mesh)["x"].tolist() == [[6, 7], [8, 9]]


# -----------------------------------------------------------------------------
# the CLIs under torchrun


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """test_torch_train_cli.py's tone corpus (its helpers import JAX, so the
    spawned ranks, which import this module, do not import them)."""
    from larynx_tpu_torch.io import wavfile

    from test_torch_pipeline import PHONEME_TABLE, VOCODER_CONFIG, VOICE_CONFIG

    root = tmp_path_factory.mktemp("torch_dist_cli")
    wav_dir = root / "wavs"
    wav_dir.mkdir()
    rng = np.random.default_rng(0)
    texts = ["Hello world.", "A voice is born.", "Testing one two three.", "The quick brown fox."]
    rows = []
    for i, text in enumerate(texts):
        n = int(22050 * (0.6 + 0.15 * i))
        t = np.arange(n) / 22050.0
        audio = 0.3 * np.sin(2 * np.pi * (120 + 20 * i) * t) + 0.05 * rng.standard_normal(n)
        wavfile.write(wav_dir / f"utt{i}.wav", 22050, (audio * 32767).astype(np.int16))
        rows.append(f"utt{i}|{text}")
    (root / "metadata.csv").write_text("\n".join(rows), encoding="utf-8")
    (root / "config.json").write_text(json.dumps(VOICE_CONFIG), encoding="utf-8")
    (root / "vocoder.json").write_text(json.dumps(VOCODER_CONFIG), encoding="utf-8")
    (root / "phonemes.txt").write_text(
        "".join(f"{i} {p}\n" for i, p in enumerate(PHONEME_TABLE)), encoding="utf-8")
    return root


def _torchrun(module, argv, tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc-per-node", "2",
         "--master-addr", "127.0.0.1", "--master-port", str(_free_port()), "-m", module, *argv],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout + proc.stderr


def test_torchrun_train_model_parallel_2(corpus, tmp_path):
    """``train --model-parallel 2`` under a world of 2 (one data rank, the
    encoder split over two model ranks): rank 0 alone writes and logs its
    saves, and the gathered voice loads and speaks on the CPU."""
    from larynx_tpu_torch.convert.native import load_params

    voices = tmp_path / "voices"
    lang, name = VOICE.split("_", 1)
    log = _torchrun("larynx_tpu_torch.train", [
        "--metadata", str(corpus / "metadata.csv"), "--wav-dir", str(corpus / "wavs"),
        "--output-dir", str(voices / lang / name), "--config", str(corpus / "config.json"),
        "--phonemes", str(corpus / "phonemes.txt"), "--batch-size", "2", "--epochs", "1",
        "--max-id-len", "64", "--max-mel-len", "128", "--ddi", "--warmup-steps", "1",
        "--model-parallel", "2", "--device", "cpu"], tmp_path)
    assert log.count("Saved checkpoint at step 2") == 1, log[-3000:]
    assert "mesh: data 1, model 2" in log
    saved = load_params(voices / lang / name / "generator.npz")
    layers = saved["encoder"]["layers"]
    assert layers["conv1_w"].shape[-1] == 128 and layers["q_w"].shape[-1] == 64
    _speaks(voices, VOICE, VOCODER, TEXT, corpus)


def test_torchrun_train_vocoder_data_parallel(corpus, tmp_path):
    """HiFi-GAN data parallel over two ranks, one row each: rank 0 alone
    writes, and the vocoder loads and speaks on the CPU."""
    log = _torchrun("larynx_tpu_torch.train_vocoder", [
        "--wav-dir", str(corpus / "wavs"), "--out-dir", str(tmp_path / "voices" / VOCODER),
        "--config", str(corpus / "vocoder.json"), "--segment-frames", "16", "--batch-size", "2",
        "--steps", "2", "--device", "cpu"], tmp_path)
    assert log.count("Saved vocoder checkpoint at step 2") == 1, log[-3000:]
    _stage_voice(tmp_path / "voices", VOICE, corpus)
    _speaks(tmp_path / "voices", VOICE, VOCODER, TEXT, corpus)


def _stage_voice(voices, voice, corpus):
    """A random voice beside the trained vocoder, as the CLI tests stage it."""
    from larynx_tpu_torch.convert.native import save_params
    from larynx_tpu_torch.models.glow_tts import config_from_voice_json

    cfg = json.loads((corpus / "config.json").read_text())
    lang, name = voice.split("_", 1)
    voice_dir = voices / lang / name
    voice_dir.mkdir(parents=True)
    (voice_dir / "config.json").write_text(json.dumps(cfg))
    (voice_dir / "phonemes.txt").write_text((corpus / "phonemes.txt").read_text())
    save_params(voice_dir / "generator.npz",
                init_params(torch.Generator().manual_seed(3), config_from_voice_json(cfg)))


def _speaks(voices, voice, vocoder, text, corpus):
    larynx_tpu_torch._TTS_MODEL_CACHE.clear()
    larynx_tpu_torch._VOCODER_MODEL_CACHE.clear()
    larynx_tpu_torch._ENGINE_CACHE.clear()
    if not (voices / vocoder).exists():
        (voices / vocoder).parent.mkdir(parents=True, exist_ok=True)
        _stage_vocoder(voices / vocoder, corpus)
    results = list(larynx_tpu_torch.text_to_speech(
        text, voice_or_lang=voice, vocoder_or_quality=vocoder, custom_voices_dir=voices,
        no_download=True, device="cpu"))
    assert results and all(r.audio.dtype == np.int16 and r.audio.size > 1000 for r in results)
    assert all(np.isfinite(r.audio.astype(np.float32)).all() for r in results)


def _stage_vocoder(voc_dir, corpus):
    from larynx_tpu_torch.convert.native import save_params
    from larynx_tpu_torch.models.hifi_gan import hifi_gan_config_from_json

    voc_dir.mkdir(parents=True)
    cfg = json.loads((corpus / "vocoder.json").read_text())
    (voc_dir / "config.json").write_text(json.dumps(cfg))
    save_params(voc_dir / "generator.npz",
                init_params(torch.Generator().manual_seed(4), hifi_gan_config_from_json(cfg)))
