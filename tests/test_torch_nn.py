"""The port's nn primitives and parameter bridge against the JAX package, on CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: 1e-5 absolute in float32.  Both sides compute the same sums of
at most a few hundred products of O(1) values; only the summation order
differs (XLA's CPU conv vs torch's), which moves results by a few ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larynx_tpu.models import nn as jnn
from larynx_tpu.models.glow_tts import GlowTTSConfig as JGlowTTSConfig
from larynx_tpu.models.glow_tts import init_params as j_glow_init
from larynx_tpu.models.hifi_gan import HiFiGanConfig as JHiFiGanConfig
from larynx_tpu.models.hifi_gan import init_params as j_hifi_init
from larynx_tpu_torch import weights
from larynx_tpu_torch.models import nn as tnn
from larynx_tpu_torch.models.glow_tts import GlowTTSConfig
from larynx_tpu_torch.models.hifi_gan import HiFiGanConfig

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _conv_w(w):
    """JAX conv weight [k, Ci, Co] -> torch [Co, Ci, k]."""
    return _t(np.swapaxes(w, 0, 2).copy())


@pytest.mark.parametrize("k,dilation,padding", [(3, 1, None), (5, 2, None), (7, 1, 3), (11, 5, None)])
def test_conv1d(k, dilation, padding):
    rng = np.random.default_rng(k * 10 + dilation)
    x = rng.standard_normal((2, 37, 12)).astype(np.float32)
    w = rng.standard_normal((k, 12, 9)).astype(np.float32) * 0.2
    b = rng.standard_normal(9).astype(np.float32)
    ref = np.asarray(jnn.conv1d(x, w, b, dilation=dilation, padding=padding))
    out = tnn.conv1d(_t(x), _conv_w(w), _t(b), dilation=dilation, padding=padding).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("k,stride", [(16, 8), (4, 2), (8, 4)])
def test_conv_transpose1d(k, stride):
    rng = np.random.default_rng(k + stride)
    x = rng.standard_normal((2, 11, 10)).astype(np.float32)
    w = rng.standard_normal((k, 10, 6)).astype(np.float32) * 0.2
    b = rng.standard_normal(6).astype(np.float32)
    pad = (k - stride) // 2
    ref = np.asarray(jnn.conv_transpose1d(x, w, b, stride=stride, padding=pad))
    w_t = _t(np.moveaxis(w, 0, -1).copy())  # [k, Ci, Co] -> [Ci, Co, k]
    out = tnn.conv_transpose1d(_t(x), w_t, _t(b), stride=stride, padding=pad).numpy()
    assert out.shape == ref.shape == (2, (11 - 1) * stride + k - 2 * pad, 6)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_layer_norm_mask_lrelu_matmul():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 17, 24)).astype(np.float32) * 3.0
    g = rng.standard_normal(24).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    np.testing.assert_allclose(
        tnn.layer_norm(_t(x), _t(g), _t(b)).numpy(),
        np.asarray(jnn.layer_norm(x, g, b)),
        atol=ATOL, rtol=0,
    )
    lengths = np.array([5, 17, 1], dtype=np.int32)
    np.testing.assert_array_equal(
        tnn.sequence_mask(torch.from_numpy(lengths), 17).numpy(),
        np.asarray(jnn.sequence_mask(jnp.asarray(lengths), 17)),
    )
    np.testing.assert_array_equal(
        tnn.leaky_relu(_t(x), 0.01).numpy(), np.asarray(jnn.leaky_relu(x, 0.01))
    )
    w = rng.standard_normal((24, 7)).astype(np.float32)
    np.testing.assert_allclose(
        tnn.matmul1x1(_t(x), _t(w.T.copy()), _t(b[:7])).numpy(),
        np.asarray(jnn.matmul1x1(x, w, b[:7])),
        atol=ATOL, rtol=0,
    )


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tuple(np.shape(tree))}


@pytest.mark.parametrize(
    "torch_cfg,jax_init,jax_cfg",
    [
        (
            GlowTTSConfig(hidden_channels=32, filter_channels=48, filter_channels_dp=24,
                          n_layers_enc=2, n_blocks_dec=2, n_block_layers=2),
            j_glow_init,
            JGlowTTSConfig(hidden_channels=32, filter_channels=48, filter_channels_dp=24,
                           n_layers_enc=2, n_blocks_dec=2, n_block_layers=2),
        ),
        (HiFiGanConfig(upsample_initial_channel=32), j_hifi_init,
         JHiFiGanConfig(upsample_initial_channel=32)),
        (HiFiGanConfig(resblock="2", upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
                       upsample_initial_channel=64, resblock_kernel_sizes=(3, 5, 7),
                       resblock_dilation_sizes=((1, 2), (2, 6), (3, 12))),
         j_hifi_init,
         JHiFiGanConfig(resblock="2", upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
                        upsample_initial_channel=64, resblock_kernel_sizes=(3, 5, 7),
                        resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)))),
    ],
    ids=["glow_tts", "hifi_gan_resblock1", "hifi_gan_resblock2"],
)
def test_init_params_matches_jax_tree(torch_cfg, jax_init, jax_cfg):
    """The port's init gives the JAX init's tree, shapes and init scale."""
    ours = weights.init_params(torch.Generator().manual_seed(0), torch_cfg)
    ref = jax_init(jax.random.PRNGKey(0), jax_cfg)
    assert _shapes(ours) == _shapes(ref)
    flat_ours = dict(_flat(ours))
    for name, leaf in _flat(ref):
        leaf = np.asarray(leaf)
        # same distribution family and bound: max |x| within 5% of the JAX draw's
        # for uniform inits; exact zeros/ones where JAX has constants
        if leaf.size > 1 and np.all(leaf == leaf.flat[0]):
            np.testing.assert_array_equal(flat_ours[name], leaf, err_msg=name)
        elif leaf.size >= 64 and "emb" not in name and "invconv" not in name:
            assert abs(np.abs(flat_ours[name]).max() / np.abs(leaf).max() - 1) < 0.05, name


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], np.asarray(tree)


def test_params_from_jax_layouts():
    cfg = JHiFiGanConfig(upsample_initial_channel=32)
    ref = j_hifi_init(jax.random.PRNGKey(1), cfg)
    ours = weights.params_from_jax(jax.tree.map(np.asarray, ref), "hifi_gan")
    w = np.asarray(ref["conv_pre"]["w"])  # [7, 80, 32]
    assert tuple(ours["conv_pre"]["w"].shape) == (32, 80, 7)
    np.testing.assert_array_equal(ours["conv_pre"]["w"].numpy(), np.transpose(w, (2, 1, 0)))
    up = np.asarray(ref["ups"][0]["w"])  # [16, 32, 16]
    assert tuple(ours["ups"][0]["w"].shape) == (32, 16, 16)
    np.testing.assert_array_equal(ours["ups"][0]["w"].numpy(), np.transpose(up, (1, 2, 0)))

    gcfg = JGlowTTSConfig(hidden_channels=32, filter_channels=48, filter_channels_dp=24,
                          n_layers_enc=2, n_blocks_dec=2, n_block_layers=2)
    gref = jax.tree.map(np.asarray, j_glow_init(jax.random.PRNGKey(2), gcfg))
    gours = weights.params_from_jax(gref, "glow_tts")
    q = gref["encoder"]["layers"]["q_w"]  # [L, Ci, Co]
    np.testing.assert_array_equal(gours["encoder"]["layers"]["q_w"].numpy(), np.swapaxes(q, 1, 2))
    in_w = gref["decoder"]["coupling"]["wn"]["in_w"]  # [N, L, k, Ci, Co]
    np.testing.assert_array_equal(
        gours["decoder"]["coupling"]["wn"]["in_w"].numpy(), np.swapaxes(in_w, 2, 4)
    )
    np.testing.assert_array_equal(
        gours["decoder"]["invconv"]["weight"].numpy(), gref["decoder"]["invconv"]["weight"]
    )
