"""The port's Griffin-Lim (``dsp/stft.py``, ``dsp/mel.py``,
``models/griffin_lim.py``, ``griffin_lim.py``) against ``larynx_tpu``, on CPU.

The same numpy magnitudes, mels and initial phase from a seed go through
both packages (JAX on its CPU FFT branch).  Tolerances, on the max-abs
difference over the output's peak:

* one STFT/iSTFT pass (overlap-add, iSTFT, one projection): 1e-5, float32
  FFTs of pocketfft and torch.fft round differently (~1e-7 per value);
* whole Griffin-Lim loops of 60 iterations at an injected phase: 2e-4.
  Sixty chained projections carry those roundings along; at these sizes
  the two sides sit 2e-5 (momentum 0) and 1e-5 (momentum 0.99) apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import larynx_tpu.dsp.mel as jmel
import larynx_tpu.dsp.stft as jdsp
from larynx_tpu.audio import mel_basis
from larynx_tpu.models import griffin_lim as jgl

import larynx_tpu_torch
import larynx_tpu_torch.dsp.mel as tmel
import larynx_tpu_torch.dsp.stft as tdsp
from larynx_tpu_torch.griffin_lim import GriffinLimVocoder
from larynx_tpu_torch.models import griffin_lim as tgl

PASS_TOL = 1e-5
LOOP_TOL = 2e-4
FFT, HOP = 256, 64


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _magnitudes(seed=0, frames=20, b=2, fft=FFT):
    rng = np.random.default_rng(seed)
    mag = (np.abs(rng.standard_normal((b, fft // 2 + 1, frames))) * 3).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, mag.shape).astype(np.float32)
    return mag, phase


@pytest.mark.parametrize("hop,out_len", [(64, None), (64, 700), (64, 2000), (48, None)],
                         ids=["full", "cut", "padded", "hop-not-dividing"])
def test_istft_overlap_add_matches_jax(hop, out_len):
    frames = np.random.default_rng(1).standard_normal((2, 9, FFT)).astype(np.float32)
    out_len = out_len or 8 * hop + FFT
    ref = jdsp.istft_overlap_add(jnp.asarray(frames), FFT, hop, out_len)
    out = tdsp.istft_overlap_add(torch.from_numpy(frames), FFT, hop, out_len)
    assert _rel(out, ref) < PASS_TOL


def test_istft_matches_jax():
    mag, phase = _magnitudes(2)
    spec = mag * np.exp(1j * phase)
    ref = jdsp.istft(jnp.asarray(spec.astype(np.complex64)), FFT, HOP)
    out = tdsp.istft(torch.from_numpy(spec.astype(np.complex64)), FFT, HOP)
    assert out.shape == (2, 20 * HOP + FFT)
    assert _rel(out, ref) < PASS_TOL


@pytest.mark.parametrize("layout", ["freq-major", "frames-major"])
def test_phase_project_matches_jax(layout):
    mag, phase = _magnitudes(3)
    signal = np.array(jdsp.inverse_magnitude_phase(jnp.asarray(mag), jnp.asarray(phase),
                                                     FFT, HOP))
    if layout == "freq-major":
        ref = jdsp.phase_project(jnp.asarray(mag), jnp.asarray(signal), FFT, HOP)
        out = tdsp.phase_project(torch.from_numpy(mag), torch.from_numpy(signal), FFT, HOP)
    else:
        frames_major = np.ascontiguousarray(mag.transpose(0, 2, 1))
        ref = jdsp.phase_project_frames(jnp.asarray(frames_major), jnp.asarray(signal), FFT, HOP)
        out = tdsp.phase_project_frames(torch.from_numpy(frames_major),
                                        torch.from_numpy(signal), FFT, HOP)
    assert _rel(out, ref) < PASS_TOL


@pytest.mark.parametrize("momentum", [0.0, 0.99], ids=["plain", "fast"])
def test_griffin_lim_matches_jax_at_injected_phase(momentum):
    mag, phase = _magnitudes(4)
    ref = jdsp.griffin_lim(jnp.asarray(mag), None, FFT, HOP, 60,
                           initial_phase=jnp.asarray(phase), momentum=momentum)
    out = tdsp.griffin_lim(torch.from_numpy(mag), None, FFT, HOP, 60,
                           initial_phase=torch.from_numpy(phase), momentum=momentum)
    assert out.shape == (2, 20 * HOP + FFT)
    assert _rel(out, ref) < LOOP_TOL


def test_griffin_lim_zero_iterations_is_the_initial_signal():
    mag, phase = _magnitudes(5)
    for momentum in (0.0, 0.99):
        out = tdsp.griffin_lim(torch.from_numpy(mag), None, FFT, HOP, 0,
                               initial_phase=torch.from_numpy(phase), momentum=momentum)
        want = tdsp.inverse_magnitude_phase(torch.from_numpy(mag), torch.from_numpy(phase),
                                            FFT, HOP)
        torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_griffin_lim_random_phase_comes_from_the_generator():
    mag = torch.from_numpy(_magnitudes(6)[0])
    run = lambda seed: tdsp.griffin_lim(  # noqa: E731
        mag, torch.Generator().manual_seed(seed), FFT, HOP, 2)
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()


def test_fast_griffin_lim_converges_better():
    """As the JAX package's test: momentum 0.99 ends nearer the target
    magnitudes than plain iteration at the same count, from one phase."""
    t = np.linspace(0, 1, 22050, dtype=np.float32)
    rng = np.random.default_rng(3)
    sig = (0.5 * np.sin(2 * np.pi * 220 * t) + 0.3 * np.sin(2 * np.pi * 660 * t + 1.0)
           + 0.05 * rng.standard_normal(t.shape).astype(np.float32))
    mag, _ = tdsp.stft_magnitude_phase(torch.from_numpy(sig)[None], 1024, 256)

    def sc_error(audio):
        m, _ = tdsp.stft_magnitude_phase(audio, 1024, 256)
        n = min(m.shape[-1], mag.shape[-1])
        m, ref = m[..., :n].double(), mag[..., :n].double()
        alpha = (m * ref).sum() / (m * m).sum()
        return float(torch.linalg.norm(alpha * m - ref) / torch.linalg.norm(ref))

    plain = tdsp.griffin_lim(mag, torch.Generator().manual_seed(0), 1024, 256, 30)
    fast = tdsp.griffin_lim(mag, torch.Generator().manual_seed(0), 1024, 256, 30, momentum=0.99)
    assert sc_error(fast) < 0.9 * sc_error(plain)


def test_linear_from_mel_matches_jax():
    rng = np.random.default_rng(7)
    mels = rng.uniform(-4.0, 2.0, size=(2, 80, 30)).astype(np.float32)
    basis = mel_basis(22050, 1024, 80, 0.0, 8000.0)
    ref = jmel.linear_from_mel(jnp.asarray(mels), jnp.asarray(basis), 1000.0)
    out = tmel.linear_from_mel(torch.from_numpy(mels), torch.from_numpy(basis), 1000.0)
    assert out.shape == (2, 513, 30)
    assert _rel(out, ref) < PASS_TOL
    torch.testing.assert_close(tmel.dynamic_range_decompression(torch.from_numpy(mels), 2.0),
                               torch.from_numpy(np.array(jmel.dynamic_range_decompression(
                                   jnp.asarray(mels), 2.0))), rtol=1e-6, atol=0)


def test_model_mels_to_audio_matches_jax_at_injected_phase():
    rng = np.random.default_rng(11)
    mels = rng.uniform(-4.0, 2.0, size=(1, 80, 24)).astype(np.float32)
    basis = mel_basis(22050, 1024, 80, 0.0, 8000.0)
    phase = rng.uniform(0, 2 * np.pi, (1, 513, 23)).astype(np.float32)
    ref = jgl.mels_to_audio(jnp.asarray(mels), jnp.asarray(basis),
                            initial_phase=jnp.asarray(phase), n_iters=60)
    out = tgl.mels_to_audio(torch.from_numpy(mels), torch.from_numpy(basis),
                            initial_phase=torch.from_numpy(phase), n_iters=60)
    assert out.shape == (1, 23 * 256 + 1024)
    assert _rel(out, ref) < LOOP_TOL


def test_griffin_lim_vocoder_loads_and_runs_on_the_named_device():
    vocoder = larynx_tpu_torch.get_vocoder_model("griffin_lim")
    assert isinstance(vocoder, GriffinLimVocoder)
    assert larynx_tpu_torch.get_vocoder_model("griffin_lim") is vocoder
    assert isinstance(larynx_tpu_torch.load_vocoder_model(
        larynx_tpu_torch.VocoderType.GRIFFIN_LIM, ""), GriffinLimVocoder)
    mels = np.random.default_rng(12).uniform(-4.0, 1.0, size=(1, 80, 12)).astype(np.float32)
    small = GriffinLimVocoder(iterations=3)
    a, b = small.mels_to_audio(mels, device="cpu"), small.mels_to_audio(mels, device="cpu")
    assert a.dtype == np.float32 and a.shape == (11 * 256 + 1024,)
    assert np.isfinite(a).all() and np.abs(a).max() > 0
    assert not np.array_equal(a, b)  # each call draws its phase from the next seed
    # the same draw as the JAX wrapper's loop at that phase: the generator seeded 1
    gen = torch.Generator().manual_seed(1)
    want = tgl.mels_to_audio(torch.from_numpy(mels), small.state.basis, generator=gen, n_iters=3)
    np.testing.assert_array_equal(a, want.numpy()[0])

