"""The port's WaveGlow training direction against ``larynx_tpu``'s, on the CPU.

Same numpy params (the JAX init under a fixed key at
``tests/test_waveglow.py``'s SMALL_CFG, with the zero-init coupling end
convs perturbed: with ``end_w = 0`` every coupling is the identity and most
WN gradients are exactly 0) and audio through both packages.  Tolerances:

* ``forward`` (z, log_s_total, logdet_w_total) and ``loss_fn``: float32 sums
  in another order through 4 flows, ~1e-7 relative; held to 1e-5 of each
  output's scale.
* every gradient of ``loss_fn``: the port's float32 against ``jax.grad`` in
  float64 under ``jax.enable_x64()``, within 1e-4 of each leaf's scale
  (float32 rounding of sums over B * blocks terms).
* the flow's round trip, reverse(forward(audio)) through the port's
  ``infer``: 1e-4, as ``tests/test_waveglow.py``.
* log|det dz/daudio| from a numerical Jacobian: 1e-4, as
  ``tests/test_waveglow.py``.
* one optimizer step on JAX's gradients against ``optax.adam``: 1e-6
  relative and 1e-5 of the learning rate absolute, a few float32 steps of
  the params (Adam's first update, lr * g / (|g| + eps), is ~lr in every
  element, and p + update rounds to one of the floats beside it).
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from larynx_tpu.models.waveglow import WaveGlowConfig as JConfig
from larynx_tpu.models.waveglow import model as jwg

from larynx_tpu_torch.models.waveglow import WaveGlowConfig
from larynx_tpu_torch.models.waveglow import model as twg
from larynx_tpu_torch.parallel import train as ptrain
from larynx_tpu_torch.weights import params_from_jax

from test_torch_glow_tts_training import _leaves, _scale_close
from test_waveglow import SMALL_CFG

CFG = WaveGlowConfig(**dataclasses.asdict(SMALL_CFG))
FRAMES = 4


def _perturbed(cfg=SMALL_CFG, seed=0):
    """JAX init (numpy leaves) with non-zero coupling end convs, and
    invertible 1x1s moved off the rotations of the init (whose log|det| is
    0) with their inverses recomputed."""
    params = jax.tree.map(np.asarray, jwg.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for flow in params["flows"]:
        flow["wn"]["end_w"] = (0.1 * rng.standard_normal(flow["wn"]["end_w"].shape)).astype(
            np.float32)
        w = flow["convinv"]["w"] + 0.2 * rng.standard_normal(flow["convinv"]["w"].shape)
        flow["convinv"]["w"] = w.astype(np.float32)
        flow["convinv"]["w_inv"] = np.linalg.inv(w.astype(np.float32).astype(np.float64)).astype(
            np.float32)
    return params


def _inputs(cfg=SMALL_CFG, b=2, frames=FRAMES, seed=1):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((b, frames, cfg.mel_channels)).astype(np.float32)
    audio = (0.5 * rng.standard_normal((b, frames * cfg.upsample_stride))).astype(np.float32)
    return audio, mel


@pytest.fixture(scope="module")
def jax_grads():
    """JAX's gradients of loss_fn at sigma 0.7 in float64 (numpy leaves)."""
    audio, mel = _inputs()
    f64 = jax.tree.map(lambda a: np.asarray(a, np.float64), _perturbed())
    with jax.enable_x64():
        grads = jax.jit(jax.grad(jwg.loss_fn), static_argnums=(1, 4))(
            f64, SMALL_CFG, audio.astype(np.float64), mel.astype(np.float64), 0.7)
        return jax.tree.map(np.asarray, grads)


def test_forward_and_loss_match_jax():
    params = _perturbed()
    audio, mel = _inputs()
    want = jwg.forward(params, SMALL_CFG, audio, mel)
    tparams = params_from_jax(params, "waveglow")
    got = twg.forward(tparams, CFG, torch.from_numpy(audio), torch.from_numpy(mel))
    for g, w, what in zip(got, want, ("z", "log_s_total", "logdet_w_total")):
        assert g.shape == w.shape, what
        _scale_close(g.numpy(), w, 1e-5, what)
    # the couplings are not the identity, the 1x1s not rotations
    assert float(np.abs(want[1]).min()) > 1e-2 and float(np.abs(want[2]).min()) > 1e-2
    for sigma in (1.0, 0.7):
        _scale_close(twg.loss_fn(tparams, CFG, torch.from_numpy(audio), torch.from_numpy(mel),
                                 sigma).numpy(),
                     jwg.loss_fn(params, SMALL_CFG, audio, mel, sigma), 1e-5, f"loss {sigma}")


def test_loss_gradients_match_jax_float64(jax_grads):
    """Every trainable leaf's gradient; ``w_inv`` is frozen (JAX's gradient
    there is zero: the forward direction never reads it)."""
    params = _perturbed()
    audio, mel = _inputs()
    tparams = ptrain.trainable(params_from_jax(params, "waveglow"), frozen=("w_inv",))
    twg.loss_fn(tparams, CFG, torch.from_numpy(audio), torch.from_numpy(mel), 0.7).backward()
    want = dict(_leaves(params_from_jax(jax_grads, "waveglow")))
    checked = 0
    for path, leaf in _leaves(tparams):
        ref = want[path]
        if path.endswith("w_inv"):
            assert leaf.grad is None and not leaf.requires_grad
            assert ref.abs().max().item() == 0.0
            continue
        assert leaf.grad.shape == ref.shape, path
        err = (leaf.grad - ref).abs().max().item()
        assert err <= 1e-4 * ref.abs().max().item(), (path, err)
        checked += 1
    assert checked == len(_leaves(tparams)) - SMALL_CFG.flows


def test_reverse_of_forward_is_the_audio():
    params = _perturbed()
    audio, mel = _inputs(b=2, frames=6)
    tparams = params_from_jax(params, "waveglow")
    with torch.no_grad():
        z, _, _ = twg.forward(tparams, CFG, torch.from_numpy(audio), torch.from_numpy(mel))
        back = twg.infer(twg.pack_params(tparams, CFG), CFG, torch.from_numpy(mel), z=z)
    np.testing.assert_allclose(back.numpy(), audio, rtol=1e-4, atol=1e-4)


def test_logdet_matches_numerical_jacobian():
    """log_s_total + logdet_w_total = log|det dz/daudio| (a wrong sign or a
    dropped blocks factor would keep every other check green while training
    maximises the wrong objective)."""
    cfg = WaveGlowConfig(mel_channels=2, flows=2, groups=4, early_every=2, early_size=2,
                         wn_kernel_size=3, wn_channels=8, wn_layers=1, upsample_kernel=8,
                         upsample_stride=4)
    tparams = params_from_jax(_perturbed(JConfig(**dataclasses.asdict(cfg))), "waveglow")
    audio, mel = _inputs(cfg, b=1, frames=2, seed=2)
    mel_t = torch.from_numpy(mel)

    def flat_forward(a_flat):
        return twg.forward(tparams, cfg, a_flat.reshape(1, -1), mel_t)[0].reshape(-1)

    jac = torch.autograd.functional.jacobian(flat_forward, torch.from_numpy(audio).reshape(-1))
    _sign, num_logdet = torch.linalg.slogdet(jac)
    _z, log_s_total, logdet_w_total = twg.forward(tparams, cfg, torch.from_numpy(audio), mel_t)
    np.testing.assert_allclose(float(num_logdet), float(log_s_total[0] + logdet_w_total[0]),
                               rtol=1e-4, atol=1e-4)


def test_optimizer_step_matches_optax_adam(jax_grads):
    """train_vocoder's optimizer (Adam at optax's defaults, continuous
    exponential decay) on JAX's gradients, one step, against
    ``optax.adam``; ``w_inv`` stays where it was."""
    params = _perturbed()
    grads = jax.tree.map(lambda g: g.astype(np.float32), jax_grads)
    schedule = optax.exponential_decay(2e-4, 1000, 0.999)
    opt = optax.adam(schedule)
    updates, _ = opt.update(grads, opt.init(params), params)
    want = params_from_jax(jax.tree.map(np.asarray, optax.apply_updates(params, updates)),
                           "waveglow")

    optimizer = ptrain.Optimizer(ptrain.exponential_decay(2e-4, 1000, 0.999))
    state = ptrain.init_train_state(params_from_jax(params, "waveglow"), optimizer,
                                    frozen=("w_inv",))
    tgrads = dict(_leaves(params_from_jax(grads, "waveglow")))
    for path, leaf in _leaves(state.params):
        if leaf.requires_grad:
            leaf.grad = tgrads[path].clone()
    optimizer.update(state.opt_state)
    before = dict(_leaves(params_from_jax(params, "waveglow")))
    want = dict(_leaves(want))
    for path, leaf in _leaves(state.params):
        if path.endswith("w_inv"):
            assert torch.equal(leaf, before[path])
        else:
            assert (leaf - before[path]).abs().max().item() > 1e-4, path  # ~lr: it moved
        np.testing.assert_allclose(leaf.detach().numpy(), want[path].numpy(), rtol=1e-6,
                                   atol=1e-5 * 2e-4, err_msg=path)
