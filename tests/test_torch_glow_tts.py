"""The port's GlowTTS (encoder, flows, two-stage inference) against the JAX package.

A small GlowTTS (2 encoder layers, 2 flow blocks of 2 WN layers, hidden 32)
with JAX ``init_params`` under a fixed key; the zero-initialised parts
(coupling end projection, actnorm, prenet projection) are filled with
small random values so that every path carries signal.  Inputs and noise
are made with numpy (or, for the decoder noise, ``jax.random`` as the JAX
model draws it) and handed to both packages.

Tolerance: 1e-4 absolute in float32.  Each output passes through tens of
dependent f32 reductions (attention softmax, layer norms, convs, the
12-conv reverse flow) whose summation order differs between XLA and torch
on the CPU; the observed error is ~1e-6, and the durations that set the
lengths are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larynx_tpu.models.glow_tts import GlowTTSConfig as JGlowTTSConfig
from larynx_tpu.models.glow_tts import model as jmodel
from larynx_tpu_torch.models.glow_tts import GlowTTSConfig
from larynx_tpu_torch.models.glow_tts import model as tmodel
from larynx_tpu_torch.weights import params_from_jax

ATOL = 1e-4

SMALL = dict(
    hidden_channels=32, filter_channels=48, filter_channels_dp=24,
    n_layers_enc=2, n_blocks_dec=2, n_block_layers=2,
)


def perturbed_glow_params(seed: int, cfg: JGlowTTSConfig):
    """JAX init params (numpy) with the zero-init leaves made random."""
    params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)

    def fill(d, key, scale):
        d[key] = (rng.standard_normal(d[key].shape) * scale).astype(np.float32)

    cp = params["decoder"]["coupling"]
    fill(cp, "end_w", 0.05)
    fill(cp, "end_b", 0.05)
    fill(params["decoder"]["actnorm"], "logs", 0.1)
    fill(params["decoder"]["actnorm"], "bias", 0.1)
    if cfg.prenet:
        fill(params["encoder"]["prenet"], "proj_w", 0.05)
    return params


@pytest.fixture(scope="module")
def models():
    jcfg = JGlowTTSConfig(**SMALL)
    tcfg = GlowTTSConfig(**SMALL)
    np_params = perturbed_glow_params(0, jcfg)
    return jcfg, np_params, tcfg, params_from_jax(np_params, "glow_tts")


def _ragged_ids(rng, lengths, t_bucket, num_symbols=46):
    ids = np.zeros((len(lengths), t_bucket), dtype=np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(1, num_symbols, size=n)
    return ids, np.asarray(lengths, dtype=np.int32)


def test_encode_ragged_batch(models):
    jcfg, np_params, tcfg, tparams = models
    ids, lengths = _ragged_ids(np.random.default_rng(1), [16, 9, 1], 16)
    length_scale = np.array([[1.5], [3.0], [1.0]], dtype=np.float32)
    ref = jmodel.encode(np_params, jcfg, jnp.asarray(ids), jnp.asarray(lengths), jnp.asarray(length_scale))
    out = tmodel.encode(
        tparams, tcfg, torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(lengths),
        torch.from_numpy(length_scale),
    )
    x_m, _x_logs, logw, w_ceil, y_lengths, mask = out
    np.testing.assert_allclose(x_m.numpy(), np.asarray(ref[0]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(logw.numpy(), np.asarray(ref[2]), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(w_ceil.numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(y_lengths.numpy(), np.asarray(ref[4]))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref[5]))
    assert np.all(y_lengths.numpy() % jcfg.n_sqz == 0)


def test_decode_reverse(models):
    jcfg, np_params, tcfg, tparams = models
    rng = np.random.default_rng(2)
    z = rng.standard_normal((2, 24, 80)).astype(np.float32)
    z_mask = (np.arange(24)[None, :] < np.array([[24], [14]])).astype(np.float32)
    z = z * z_mask[..., None]
    ref = np.asarray(jmodel.decode_reverse(np_params, jcfg, jnp.asarray(z), jnp.asarray(z_mask)))
    out = tmodel.decode_reverse(tparams, tcfg, torch.from_numpy(z), torch.from_numpy(z_mask))
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_expand_and_decode_with_jax_noise(models):
    jcfg, np_params, tcfg, tparams = models
    ids, lengths = _ragged_ids(np.random.default_rng(3), [12, 7], 16)
    enc = jmodel.encode(np_params, jcfg, jnp.asarray(ids), jnp.asarray(lengths), 2.0)
    x_m, x_logs, _logw, w_ceil, y_lengths, _mask = enc
    mel_max = int(-(-int(np.asarray(y_lengths).max()) // 32) * 32) + 32
    key = jax.random.PRNGKey(7)
    noise_scale = np.float32(0.667)
    ref_mel, ref_mask = jmodel.expand_and_decode(
        np_params, jcfg, x_m, x_logs, w_ceil, y_lengths, key, mel_max, noise_scale
    )
    # the noise exactly as expand_and_decode draws it
    noise = np.asarray(jax.random.normal(key, (2, mel_max, jcfg.mel_channels), dtype=jnp.float32))
    mel, z_mask = tmodel.expand_and_decode(
        tparams, tcfg,
        torch.tensor(np.asarray(x_m)), torch.tensor(np.asarray(x_logs)),
        torch.tensor(np.asarray(w_ceil)), torch.tensor(np.asarray(y_lengths)),
        mel_max, noise_scale=float(noise_scale), noise=torch.from_numpy(noise),
    )
    np.testing.assert_array_equal(z_mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_allclose(mel.numpy(), np.asarray(ref_mel), atol=ATOL, rtol=0)


def test_expand_and_decode_draws_from_generator(models):
    """Without a noise tensor the draw comes from the generator: same seed,
    same mel; noise_scale 0 removes the noise altogether."""
    _jcfg, _np_params, tcfg, tparams = models
    ids, lengths = _ragged_ids(np.random.default_rng(4), [10], 16)
    enc = tmodel.encode(tparams, tcfg, torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(lengths))
    x_m, x_logs, _logw, w_ceil, y_lengths, _ = enc
    run = lambda seed, scale: tmodel.expand_and_decode(  # noqa: E731
        tparams, tcfg, x_m, x_logs, w_ceil, y_lengths, 64, noise_scale=scale,
        generator=torch.Generator().manual_seed(seed),
    )[0]
    torch.testing.assert_close(run(5, 0.667), run(5, 0.667), rtol=0, atol=0)
    assert not torch.equal(run(5, 0.667), run(6, 0.667))
    torch.testing.assert_close(run(5, 0.0), run(6, 0.0), rtol=0, atol=0)
