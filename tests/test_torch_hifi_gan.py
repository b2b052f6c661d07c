"""The port's HiFi-GAN (MRF section, generator, STFT, denoiser) against the JAX package.

The MRF section's plain version is held against the JAX Pallas kernel run in
interpret mode (as ``tests/test_pallas_ops.py`` runs it on the CPU), at
C in {32, 64, 128}, ResBlock1 and ResBlock2, with T not a multiple of the
tile.  Generators are small (initial channel <= 64) with JAX ``init_params``
under a fixed key.

Tolerances, float32:
  * MRF section: 1e-4 absolute, the bound test_pallas_ops uses between the
    Pallas kernel and XLA: 12-18 chained convs of up to 11*128 products,
    summed in other orders.
  * generator: 1e-5 absolute on tanh-bounded audio (the small generator's
    sums are short; observed ~1e-7).
  * STFT / denoiser: 1e-3 absolute on O(10) waveforms and magnitudes,
    i.e. ~1e-4 relative: pocketfft (numpy/JAX on CPU) and torch's FFT
    round differently over 1024-point transforms, and the denoiser adds a
    magnitude clip and an overlap-add of four frames.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import larynx_tpu.dsp.stft as jstft
from larynx_tpu.models.hifi_gan import HiFiGanConfig as JHiFiGanConfig
from larynx_tpu.models.hifi_gan import denoiser as jdenoiser
from larynx_tpu.models.hifi_gan import model as jhifi
from larynx_tpu.ops.mrf_block import fused_mrf
from larynx_tpu.ops.mrf_block import pack_mrf_weights as j_pack
import larynx_tpu_torch.dsp.stft as tstft
from larynx_tpu_torch.models.hifi_gan import HiFiGanConfig
from larynx_tpu_torch.models.hifi_gan import denoiser as tdenoiser
from larynx_tpu_torch.models.hifi_gan import model as thifi
from larynx_tpu_torch.ops import mrf_block
from larynx_tpu_torch.weights import params_from_jax

RESBLOCK1 = dict(kernel_sizes=(3, 7, 11), dilations=((1, 3, 5),) * 3, convs_per_unit=2)
RESBLOCK2 = dict(kernel_sizes=(3, 5, 7), dilations=((1, 2), (2, 6), (3, 12)), convs_per_unit=1)

VCTK_SMALL = dict(
    resblock="2", upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
    upsample_initial_channel=64, resblock_kernel_sizes=(3, 5, 7),
    resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)),
)


def _random_stage(rng, c, kernel_sizes, dilations, convs_per_unit):
    def conv(k):
        return {
            "w": rng.standard_normal((k, c, c)).astype(np.float32) * 0.05,
            "b": rng.standard_normal(c).astype(np.float32) * 0.01,
        }

    if convs_per_unit == 2:
        return [
            {"convs1": [conv(k) for _ in d], "convs2": [conv(k) for _ in d]}
            for k, d in zip(kernel_sizes, dilations)
        ]
    return [{"convs": [conv(k) for _ in d]} for k, d in zip(kernel_sizes, dilations)]


def _torch_stage(stage):
    """JAX-layout resblock dicts -> the port's layout."""
    return params_from_jax({"resblocks": stage}, "hifi_gan")["resblocks"]


@pytest.mark.parametrize("channels", [32, 64, 128])
@pytest.mark.parametrize("geometry", [RESBLOCK1, RESBLOCK2], ids=["resblock1", "resblock2"])
def test_mrf_section_plain_matches_pallas_interpret(channels, geometry):
    rng = np.random.default_rng(channels)
    ks, dils, cpu = geometry["kernel_sizes"], geometry["dilations"], geometry["convs_per_unit"]
    stage = _random_stage(rng, channels, ks, dils, cpu)
    x = rng.standard_normal((2, 300, channels)).astype(np.float32)  # 300 % 128 != 0

    ref = np.asarray(
        fused_mrf(
            jnp.asarray(x), j_pack(stage), kernel_sizes=ks, dilations_per_block=dils,
            tile=128, convs_per_unit=cpu, interpret=True,
        )
    )
    packed = mrf_block.pack_mrf_stage(_torch_stage(stage), ks, dils, cpu)
    out = mrf_block.mrf_section(torch.from_numpy(x), packed)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_mrf_packing_layout():
    """Packed weights: conv i of the section is taps [k][C_in][C_out]."""
    rng = np.random.default_rng(0)
    stage = _random_stage(rng, 8, (3, 5), ((1, 2), (2, 6)), 2)
    w_flat, b_flat = mrf_block.pack_mrf_weights(_torch_stage(stage))
    assert w_flat.numel() == 2 * 8 * 8 * (3 * 2 + 5 * 2)
    assert tuple(b_flat.shape) == (8, 8)
    # chain 1, unit 0, plain conv (convs2[0]) is the 6th conv in execution order
    offset = 2 * 3 * 64 * 2 + 5 * 64
    np.testing.assert_array_equal(
        w_flat[offset : offset + 5 * 64].view(5, 8, 8).numpy(), stage[1]["convs2"][0]["w"]
    )
    np.testing.assert_array_equal(b_flat[5].numpy(), stage[1]["convs2"][0]["b"])


@pytest.fixture(scope="module")
def generator_runs():
    """Per geometry, the JAX init's params (key 3), the mel and the port's
    generator audio: the same for both JAX references, so run once."""
    runs = {}

    def run(geometry):
        key = tuple(sorted(geometry.items()))
        if key not in runs:
            jcfg, tcfg = JHiFiGanConfig(**geometry), HiFiGanConfig(**geometry)
            np_params = jax.tree.map(np.asarray, jhifi.init_params(jax.random.PRNGKey(3), jcfg))
            mel = np.random.default_rng(4).standard_normal((2, 12, 80)).astype(np.float32)
            params = thifi.pack_params(params_from_jax(np_params, "hifi_gan"), tcfg)
            runs[key] = np_params, mel, thifi.generator(params, tcfg, torch.from_numpy(mel))
        return runs[key]

    return run


@pytest.mark.parametrize(
    "geometry",
    [dict(upsample_initial_channel=64), VCTK_SMALL],
    ids=["universal_large_narrow", "vctk_small_narrow"],
)
@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas_interpret"])
def test_generator_matches_jax(generator_runs, geometry, use_pallas):
    jcfg = JHiFiGanConfig(**geometry)
    np_params, mel, out = generator_runs(geometry)
    run = jax.jit(functools.partial(
        jhifi.generator, cfg=jcfg, use_pallas=use_pallas, pallas_interpret=use_pallas
    ))
    ref = np.asarray(run(np_params, mel=jnp.asarray(mel)))
    assert out.shape == ref.shape == (2, 12 * jcfg.total_upsample)
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_stft_round_trip_matches_jax():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 5000)) * 0.3).astype(np.float32)
    j_mag, j_phase = jstft.stft_magnitude_phase(jnp.asarray(x), 1024, 256)
    t_mag, t_phase = tstft.stft_magnitude_phase(torch.from_numpy(x), 1024, 256)
    assert t_mag.shape == j_mag.shape == (2, 513, tstft.num_frames(5000, 1024, 256))
    np.testing.assert_allclose(t_mag.numpy(), np.asarray(j_mag), atol=1e-3, rtol=0)
    # phase only where the bin carries energy (elsewhere it is ill-conditioned)
    loud = np.asarray(j_mag) > 1e-2
    dphi = np.angle(np.exp(1j * (t_phase.numpy() - np.asarray(j_phase))))
    assert np.abs(dphi[loud]).max() < 1e-3
    j_y = np.asarray(jstft.inverse_magnitude_phase(j_mag, j_phase, 1024, 256))
    t_y = tstft.inverse_magnitude_phase(t_mag, t_phase, 1024, 256).numpy()
    assert t_y.shape == j_y.shape
    np.testing.assert_allclose(t_y, j_y, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(tstft.hann_window(1024), jstft.hann_window(1024))


def test_denoiser_matches_jax():
    rng = np.random.default_rng(6)
    audio = (rng.standard_normal((3, 6400)) * 0.2).astype(np.float32)
    bias_audio = (rng.standard_normal((1, 88 * 256)) * 0.05).astype(np.float32)
    j_bias = jdenoiser.compute_bias_spec(jnp.asarray(bias_audio))
    t_bias = tdenoiser.compute_bias_spec(torch.from_numpy(bias_audio))
    np.testing.assert_allclose(t_bias.numpy(), np.asarray(j_bias), atol=1e-3, rtol=0)
    strength = np.array([0.0, 0.005, 0.1], dtype=np.float32).reshape(3, 1, 1)
    ref = np.asarray(jdenoiser.denoise(jnp.asarray(audio), j_bias, jnp.asarray(strength)))
    out = tdenoiser.denoise(torch.from_numpy(audio), t_bias, torch.from_numpy(strength)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)
