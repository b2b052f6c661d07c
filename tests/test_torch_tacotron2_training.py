"""The port's Tacotron2 training against ``larynx_tpu``'s, on the CPU.

Same numpy params (the JAX init under a fixed key at
``tests/test_tacotron2.py``'s CFG with ``p_prenet_dropout`` 0.5) and batch
through both packages, with JAX's own encoder and prenet dropout masks (the
bits of its ``fold_in`` keys) injected into the port.  Mel lengths are
ragged and shorter than the padding, so the unmasked gate term and the
BatchNorm statistics over padded positions count.  Tolerances:

* ``forward_teacher`` and ``loss_fn``: float32 sums in another order
  through 12 recurrent steps, ~1e-7 relative; held to 1e-5 of each output's
  scale.
* every gradient: the port's float32 against ``jax.grad`` in float64 under
  ``jax.enable_x64()``, within 1e-4 of each leaf's scale, the scale floored
  at 1e-2 of the net's largest gradient: a conv bias before a BatchNorm,
  which removes it, has a true gradient of 0 and holds float32 rounding
  noise only.
* the optimizer (global-norm clip, AdamW, linear warmup) against the optax
  chain over 3 steps: 1e-5 relative, 1e-6 absolute on O(1) params (a few
  float32 steps of them; an element that the updates bring near 0 keeps
  the absolute rounding of its start).
* the running statistics against ``torch.nn.BatchNorm1d(momentum=0.1)``:
  1e-6 relative (float32 sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from larynx_tpu.models.tacotron2 import training as jtr

from larynx_tpu_torch.models.tacotron2 import model as tm
from larynx_tpu_torch.models.tacotron2 import training as tr
from larynx_tpu_torch.models.tacotron2.config import Tacotron2Config
from larynx_tpu_torch.parallel import train as ptrain
from larynx_tpu_torch.weights import params_from_jax

from test_tacotron2 import CFG as J_BASE
from test_torch_glow_tts_training import _leaves, _run_optax, _run_port_optimizer, _scale_close

J_CFG = dataclasses.replace(J_BASE, p_prenet_dropout=0.5)
CFG = Tacotron2Config(**dataclasses.asdict(J_CFG))
KEY = jax.random.PRNGKey(3)


@pytest.fixture(scope="module")
def problem():
    """(native params, numpy batch, JAX's masks for KEY as numpy bools)."""
    params = jax.tree.map(np.asarray, jtr.init_params(jax.random.PRNGKey(0), J_CFG))
    rng = np.random.default_rng(0)
    b, t, s = 3, 10, 12
    id_lengths = np.array([10, 7, 4], np.int32)
    ids = np.where(np.arange(t)[None] < id_lengths[:, None],
                   rng.integers(1, J_CFG.num_symbols, (b, t)), 0).astype(np.int32)
    mel_lengths = np.array([12, 9, 5], np.int32)
    mels = rng.standard_normal((b, s, J_CFG.mel_channels)).astype(np.float32)
    mels *= (np.arange(s)[None, :, None] < mel_lengths[:, None, None])
    batch = {"ids": ids, "id_lengths": id_lengths, "mels": mels, "mel_lengths": mel_lengths}
    # the masks of larynx_tpu's encode and decode_teacher under KEY
    enc_key, dec_key = jax.random.fold_in(KEY, 0), jax.random.fold_in(KEY, 1)
    enc = np.stack([np.asarray(jax.random.bernoulli(jax.random.fold_in(enc_key, i), 0.5,
                                                    (b, t, J_CFG.encoder_embedding_dim)))
                    for i in range(J_CFG.encoder_n_convolutions)])
    pre = np.stack([np.asarray(jax.random.bernoulli(jax.random.fold_in(dec_key, i),
                                                    1.0 - J_CFG.p_prenet_dropout,
                                                    (b, s, J_CFG.prenet_dim)))
                    for i in range(2)])
    return params, batch, (torch.from_numpy(enc), torch.from_numpy(pre))


def _tbatch(batch):
    return ptrain.batch_to(batch, "cpu")


def test_forward_teacher_and_loss_match_jax(problem):
    params, batch, (enc, pre) = problem
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jtr.forward_teacher(params, J_CFG, jb["ids"], jb["id_lengths"], jb["mels"],
                               train=True, key=KEY)
    tb = _tbatch(batch)
    tparams = params_from_jax(params, "tacotron2")
    got = tm.forward_teacher(tparams, CFG, tb["ids"], tb["id_lengths"], tb["mels"],
                             encoder_keep=enc, prenet_keep=pre)
    for g, w, what in zip(got, want, ("mel_pre", "mel_post", "gates")):
        assert g.shape == w.shape, what
        _scale_close(g.detach().numpy(), w, 1e-5, what)
    # without the masks (JAX: no key) neither dropout runs
    plain = tm.forward_teacher(tparams, CFG, tb["ids"], tb["id_lengths"], tb["mels"])[0]
    assert not np.allclose(plain.detach().numpy(), np.asarray(want[0]), atol=1e-3)

    j_loss, j_parts = jtr.loss_fn(params, J_CFG, jb, KEY)
    loss, parts = tr.loss_fn(tparams, CFG, tb, enc, pre)
    _scale_close(loss.detach().numpy(), j_loss, 1e-5, "loss")
    for k in ("mel_pre", "mel_post", "gate"):
        _scale_close(parts[k].detach().numpy(), j_parts[k], 1e-5, k)


def test_loss_gradients_match_jax_float64(problem, monkeypatch):
    """Every trainable leaf; the BatchNorms' running statistics are frozen
    on the port's side and have zero gradients on JAX's (train mode never
    reads them).  Under x64 JAX's ``bernoulli`` would draw float64
    uniforms, other bits: its probability is passed as float32, which draws
    the float32 run's masks."""
    params, batch, (enc, pre) = problem
    f64 = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    jb = {k: np.asarray(v, np.float64) if v.dtype.kind == "f" else v for k, v in batch.items()}
    bernoulli = jax.random.bernoulli
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: bernoulli(key, np.float32(p), shape))
    with jax.enable_x64():
        grads = jax.jit(jax.grad(lambda p: jtr.loss_fn(p, J_CFG, jb, KEY)[0]))(f64)
        grads = jax.tree.map(np.asarray, grads)
    want = dict(_leaves(params_from_jax(grads, "tacotron2")))
    state = tr.init_train_state(params_from_jax(params, "tacotron2"),
                                ptrain.Optimizer(lambda k: 0.0))
    tr.loss_fn(state.params, CFG, _tbatch(batch), enc, pre)[0].backward()
    floor = 1e-2 * max(g.abs().max().item() for g in want.values())
    for path, leaf in _leaves(state.params):
        ref = want[path]
        if path.endswith(("/mean", "/var")):
            assert not leaf.requires_grad and ref.abs().max().item() == 0.0, path
            continue
        err = (leaf.grad - ref).abs().max().item()
        assert err <= 1e-4 * max(ref.abs().max().item(), floor), (path, err)


@pytest.mark.parametrize("weight_decay", [1e-6, 0.1])
def test_optimizer_matches_optax_chain(weight_decay):
    """clip_by_global_norm(1) + adamw at linear_schedule(0 -> lr over 2):
    the first update has lr 0, the last is clipped (norm ~50)."""
    shapes = [(6, 4), (4,), (2, 3, 5)]
    rng = np.random.default_rng(7)
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]
             for scale in (0.01, 0.05, 8.0)]
    opt = ptrain.Optimizer(ptrain.linear_schedule(0.0, 1e-2, 2), grad_clip=1.0,
                           clip="global_norm", weight_decay=weight_decay)
    got, lrs = _run_port_optimizer(opt, init, grads)
    schedule = optax.linear_schedule(0.0, 1e-2, 2)
    want = _run_optax(optax.chain(optax.clip_by_global_norm(1.0),
                                  optax.adamw(schedule, weight_decay=weight_decay)), init, grads)
    np.testing.assert_allclose(lrs, [float(schedule(k)) for k in range(3)], rtol=1e-6)
    assert lrs[0] == 0.0
    norms = [np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in step)) for step in grads]
    assert norms[0] < 1.0 < norms[2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_running_statistics_follow_batchnorm1d():
    """``_bn`` in train mode and ``update_bn_running`` against
    ``torch.nn.BatchNorm1d(momentum=0.1)`` fed the same activations, over
    two batches: the outputs (biased batch variance) and the running mean
    and unbiased running variance."""
    c = 6
    rng = np.random.default_rng(1)
    p = {"gamma": torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
         "beta": torch.from_numpy(rng.standard_normal(c).astype(np.float32)),
         "mean": torch.zeros(c), "var": torch.ones(c)}
    bn = torch.nn.BatchNorm1d(c, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(p["gamma"])
        bn.bias.copy_(p["beta"])
    bn.train()
    for k in range(2):
        x = torch.from_numpy((2.0 + 3.0 * rng.standard_normal((3, 7, c))).astype(np.float32))
        y, stats = tm._bn(p, x, train=True)
        tr.update_bn_running([(p, *stats, 3 * 7)])
        want = bn(x.transpose(1, 2)).transpose(1, 2)
        np.testing.assert_allclose(y.detach().numpy(), want.detach().numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(p["mean"].numpy(), bn.running_mean.numpy(), rtol=1e-6)
        np.testing.assert_allclose(p["var"].numpy(), bn.running_var.numpy(), rtol=1e-6)


def test_train_step_moves_running_statistics_by_ema_only(problem):
    """One ``make_train_step`` at a large rate and weight decay: every
    BatchNorm's ``mean``/``var`` is the EMA of its batch statistics (taken
    by a forward at the same params) and nothing else: no optimizer sees
    them, so AdamW's decay does not shrink ``var`` as it does in JAX."""
    params, batch, _ = problem
    opt = ptrain.Optimizer(lambda k: 1e-2, grad_clip=1.0, clip="global_norm", weight_decay=0.1)
    state = tr.init_train_state(params_from_jax(params, "tacotron2"), opt)
    optimized = {id(p) for group in state.opt_state.adam.param_groups for p in group["params"]}
    stats: list = []
    tr.loss_fn(state.params, CFG, _tbatch(batch), bn_stats=stats)
    expected = [(p, 0.9 * p["mean"] + 0.1 * mean.detach(),
                 0.9 * p["var"] + 0.1 * var.detach() * n / (n - 1)) for p, mean, var, n in stats]
    assert len(expected) == CFG.encoder_n_convolutions + CFG.postnet_n_convolutions
    state, metrics = tr.make_train_step(CFG, opt)(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    for p, mean, var in expected:
        assert id(p["mean"]) not in optimized and id(p["var"]) not in optimized
        np.testing.assert_allclose(p["mean"].numpy(), mean.numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(p["var"].numpy(), var.numpy(), rtol=1e-6)
        assert not torch.allclose(var, torch.ones_like(var))  # they moved
