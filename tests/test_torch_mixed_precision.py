"""Mixed precision in the port: the bfloat16 vocoder, and ``half``, against the JAX package.

Counterpart of ``tests/test_mixed_precision.py`` (default selection, flags
that compose, a bf16 vocoder audibly identical to the f32 one), plus the
bfloat16 kernels' plain versions held against the Pallas kernels in
interpret mode, the models and the engine in bfloat16 against the JAX
package's, the library, the stream and the CLI with ``half``, the bf16
weight layouts and the engine's denoiser-bias lock.  Inputs and weights come
from numpy seeds; on the CPU every wrapper runs its plain version.

Tolerances:
  * kernel level (the plain MRF section and WN layer against ``fused_mrf`` /
    ``fused_wn_layer_state`` / ``fused_wn_layer`` in bf16): at most 2 bf16
    ULPs of the reference's scale, ``2^(floor(log2 max|ref|) - 7)``, per
    element.  Both sides round at the same points and sum exact bf16
    products in f32 in other orders, so a value near a rounding boundary can
    land one ULP apart and carry into the chained convs; XLA on the CPU also
    keeps excess precision between bf16 ops by default.  1 ULP was measured.
  * rounding points: with ``XLA_FLAGS=--xla_allow_excess_precision=false``
    (a subprocess, since XLA reads its flags once) at least 99.9% of the
    elements are exact, for an MRF section of two chains of two ResBlock1
    units (C=32, T=300) and a middle WN layer; a rounding point placed
    elsewhere moves about a quarter of them.
  * end to end: the JAX package's bar (``tests/test_mixed_precision.py``):
    correlation > 0.999 against f32, and the RMS level within 1% of full
    scale; the same bar holds the port's bf16 against the JAX package's bf16.
  * WaveGlow: the port's bf16 audio is no further from its f32 run than the
    JAX package's bf16 WaveGlow is from its own f32 run, at the same
    geometry (relative RMS error), within 10%: XLA's excess precision on the
    CPU keeps the JAX run slightly closer to f32 than bf16 rounds.

Durations can flip a frame in bf16 under ``half``: GlowTTS is compared at
the JAX side's ``w_ceil`` with the latent noise injected, not through the
``ceil`` of two bf16 runs.
"""

import io
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import larynx_tpu
import larynx_tpu.__main__ as jcli
from larynx_tpu.audio import AudioSettings as JAudioSettings
from larynx_tpu.models.glow_tts import config_from_voice_json
from larynx_tpu.models.glow_tts import init_params as j_glow_init
from larynx_tpu.models.glow_tts import model as j_glow
from larynx_tpu.models.hifi_gan import HiFiGanConfig as JHiFiGanConfig
from larynx_tpu.models.hifi_gan import hifi_gan_config_from_json
from larynx_tpu.models.hifi_gan import init_params as j_hifi_init
from larynx_tpu.models.hifi_gan import model as j_hifi
from larynx_tpu.models.nn import leaky_relu as j_leaky_relu
from larynx_tpu.models.waveglow import WaveGlowConfig as JWaveGlowConfig
from larynx_tpu.models.waveglow import model as jwg
from larynx_tpu.ops.mrf_block import fused_mrf
from larynx_tpu.ops.mrf_block import pack_mrf_weights as j_pack
from larynx_tpu.ops.wn_layer import fused_wn_layer as j_wn_layer
from larynx_tpu.ops.wn_layer import fused_wn_layer_state as j_wn_layer_state
from larynx_tpu.runtime.engine import SynthesisEngine as JEngine
from larynx_tpu.runtime.engine import default_vocoder_half as j_default_vocoder_half

import larynx_tpu_torch
import larynx_tpu_torch.__main__ as cli
from larynx_tpu_torch.audio import AudioSettings
from larynx_tpu_torch.io import wavfile
from larynx_tpu_torch.models import nn as tnn
from larynx_tpu_torch.models.glow_tts import config_from_voice_json as t_glow_config
from larynx_tpu_torch.models.glow_tts import model as t_glow
from larynx_tpu_torch.models.hifi_gan import HiFiGanConfig
from larynx_tpu_torch.models.hifi_gan import hifi_gan_config_from_json as t_hifi_config
from larynx_tpu_torch.models.hifi_gan import model as t_hifi
from larynx_tpu_torch.models.waveglow import WaveGlowConfig
from larynx_tpu_torch.models.waveglow import model as twg
from larynx_tpu_torch.ops import mrf_block, wn_layer
from larynx_tpu_torch.runtime import engine as tengine
from larynx_tpu_torch.weights import cast, params_from_jax

from test_torch_pipeline import (  # noqa: F401
    AUDIO, TEXT, VOCODER, VOCODER_CONFIG, VOICE, VOICE_CONFIG, voices_dir,
)
from test_torch_waveglow import SMALL as WG_SMALL

REPO = Path(__file__).resolve().parent.parent
BF16 = torch.bfloat16
RESBLOCK1 = ((3, 7, 11), ((1, 3, 5),) * 3, 2)  # universal_large
RESBLOCK2 = ((3, 5, 7), ((1, 2), (2, 6), (3, 12)), 1)  # vctk_small
ULPS = 2
CORRELATION = 0.999
LEVEL = 0.01 * 32767


@pytest.fixture(scope="module", autouse=True)
def _fresh_model_caches():
    """Both packages' model and engine caches, emptied around this module:
    its entry-point tests load the shared test voice and vocoder with
    ``half=True``, and the JAX package's ``HiFiGanVocoder`` keeps bf16
    params for as long as it is cached, which would reach the float32
    comparisons of a later test file in the same worker."""
    def clear():
        for module in (larynx_tpu, larynx_tpu_torch):
            module._TTS_MODEL_CACHE.clear()
            module._VOCODER_MODEL_CACHE.clear()
            module._ENGINE_CACHE.clear()

    clear()
    yield
    clear()


def _bf16_np(a):
    """numpy values rounded to bfloat16, as float32."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _ulps_of_scale(out: np.ndarray, ref: np.ndarray) -> float:
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    return float(np.abs(out - ref).max() / ulp)


def _corr(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.corrcoef(a, b)[0, 1])


def _rms(a) -> float:
    return float(np.sqrt(np.mean(np.asarray(a, np.float64) ** 2)))


def _audibly_identical(x, y):
    """The JAX package's bar for int16 audio: correlation and RMS level."""
    assert x.shape == y.shape
    assert _corr(x, y) > CORRELATION, _corr(x, y)
    assert abs(_rms(x) - _rms(y)) < LEVEL, (_rms(x), _rms(y))


def _half_agrees(x, y, correlation=CORRELATION, n_sqz=2):
    """Audio of a ``half`` run, through ceil'd bf16 durations: a flipped
    frame shifts the audio, so the bar is shift-free where lengths differ:
    the lengths within two flips (2 * n_sqz frames of 256 samples) and the
    RMS level within 1% of full scale; equal lengths also meet
    ``correlation`` (None: no correlation bar)."""
    assert abs(x.shape[0] - y.shape[0]) <= 2 * n_sqz * 256, (x.shape, y.shape)
    assert abs(_rms(x) - _rms(y)) < LEVEL, (_rms(x), _rms(y))
    if x.shape == y.shape and correlation is not None:
        assert _corr(x, y) > correlation, _corr(x, y)


# -----------------------------------------------------------------------------
# Default selection and flags (tests/test_mixed_precision.py)


def test_default_selection(monkeypatch):
    """bfloat16 on a CUDA device, float32 on the CPU, the env override
    winning either way; the JAX package's contract under the same env."""
    monkeypatch.delenv("LARYNX_TPU_VOCODER_PRECISION", raising=False)
    assert tengine.default_vocoder_half("cpu") is False
    assert tengine.default_vocoder_half("cuda") is True
    assert tengine.default_vocoder_half() is torch.cuda.is_available()
    assert j_default_vocoder_half() is False  # the JAX package on its CPU backend
    for value, want in (("bf16", True), ("bfloat16", True), ("half", True), ("f32", False),
                        ("float32", False), ("full", False)):
        monkeypatch.setenv("LARYNX_TPU_VOCODER_PRECISION", value)
        assert tengine.default_vocoder_half("cpu") is want
        assert tengine.default_vocoder_half("cuda") is want
        assert j_default_vocoder_half() is want


@pytest.fixture(scope="module")
def small_models():
    """Numpy params of the pipeline's small voice and vocoder (JAX init),
    with the voice's coupling end convs perturbed so the flows carry signal."""
    glow_cfg = config_from_voice_json(VOICE_CONFIG)
    glow_np = jax.tree.map(np.asarray, j_glow_init(jax.random.PRNGKey(0), glow_cfg))
    rng = np.random.default_rng(0)
    cp = glow_np["decoder"]["coupling"]
    cp["end_w"] = (rng.standard_normal(cp["end_w"].shape) * 0.05).astype(np.float32)
    voc_cfg = hifi_gan_config_from_json(VOCODER_CONFIG)
    voc_np = jax.tree.map(np.asarray, j_hifi_init(jax.random.PRNGKey(1), voc_cfg))
    return glow_np, voc_np


def _port_engine(small_models, **flags):
    glow_np, voc_np = small_models
    return tengine.SynthesisEngine(
        params_from_jax(glow_np, "glow_tts"), t_glow_config(VOICE_CONFIG), AudioSettings(**AUDIO),
        vocoder_params=params_from_jax(voc_np, "hifi_gan"),
        vocoder_cfg=t_hifi_config(VOCODER_CONFIG), device="cpu", seed=7, **flags,
    )


def _jax_engine(small_models, **flags):
    glow_np, voc_np = small_models
    return JEngine(glow_np, config_from_voice_json(VOICE_CONFIG), JAudioSettings(**AUDIO),
                   vocoder_kind="hifi_gan", vocoder_params=voc_np,
                   vocoder_cfg=hifi_gan_config_from_json(VOCODER_CONFIG), seed=7,
                   use_pallas=False, **flags)


@pytest.mark.parametrize("flags,dtype,voc_dtype", [
    ({}, torch.float32, torch.float32),
    ({"vocoder_half": False}, torch.float32, torch.float32),
    ({"vocoder_half": True}, torch.float32, BF16),
    ({"half": True}, BF16, BF16),
    ({"half": True, "vocoder_half": False}, BF16, torch.float32),
], ids=["default-cpu", "f32", "vocoder_half", "half", "half-f32-vocoder"])
def test_flags_compose(small_models, monkeypatch, flags, dtype, voc_dtype):
    """vocoder_half keeps the flows float32; half makes both bfloat16; an
    explicit vocoder_half wins over half, as in the JAX engine."""
    monkeypatch.delenv("LARYNX_TPU_VOCODER_PRECISION", raising=False)
    port = _port_engine(small_models, **flags)
    ref = _jax_engine(small_models, **flags)
    assert (port.dtype, port.voc_dtype) == (dtype, voc_dtype)
    assert (ref.dtype == jnp.bfloat16, ref.voc_dtype == jnp.bfloat16) == (dtype == BF16,
                                                                         voc_dtype == BF16)
    assert port.glow_params["decoder"]["coupling"]["wn"]["in_w"].dtype == dtype
    assert port.vocoder_params["conv_pre"]["w"].dtype == voc_dtype
    stages = [s for s in port.vocoder_params["mrf"] if s is not None]
    assert stages and all(s.w_flat.dtype == voc_dtype for s in stages)
    assert all(s.wpack.dtype == voc_dtype for s in stages if s.wpack is not None)


def test_leaky_relu_rounds_as_jax():
    """bfloat16 leaky-ReLU: x * bfloat16(0.1) rounded, as JAX's weak-typed
    slope computes; torch's own x * 0.1 rounds differently on ~10% of all
    values (~20% of the negative ones).  float32 is unchanged."""
    rng = np.random.default_rng(0)
    x = _bf16_np(rng.standard_normal(100_000) * 3)
    for slope in (0.1, 0.01):
        ref = np.asarray(j_leaky_relu(jnp.asarray(x, jnp.bfloat16), slope).astype(jnp.float32))
        out = tnn.leaky_relu(torch.from_numpy(x).to(BF16), slope)
        assert out.dtype == BF16
        np.testing.assert_array_equal(out.float().numpy(), ref)
    naive = torch.nn.functional.leaky_relu(torch.from_numpy(x).to(BF16), 0.1).float().numpy()
    assert np.mean(naive != ref) > 0.05
    assert mrf_block.LRELU_SLOPE_BF16 == tnn.bf16_value(mrf_block.LRELU_SLOPE)
    f32 = torch.from_numpy(x)
    torch.testing.assert_close(tnn.leaky_relu(f32, 0.1), torch.where(f32 >= 0, f32, f32 * 0.1),
                               rtol=0, atol=0)


def test_cast_keeps_integers():
    tree = {"a": torch.ones(3), "b": [torch.arange(3), {"c": torch.zeros(2, dtype=torch.float64)}]}
    out = cast(tree, BF16)
    assert out["a"].dtype == BF16 and out["b"][1]["c"].dtype == BF16
    assert out["b"][0].dtype == torch.int64


# -----------------------------------------------------------------------------
# Kernel level: the plain bf16 versions against the Pallas kernels


def _random_stage(rng, c, kernel_sizes, dilations, convs_per_unit):
    """JAX-layout resblock dicts (convs [k, C_in, C_out]), bf16 values."""
    def conv(k):
        return {"w": _bf16_np(rng.standard_normal((k, c, c)) * 0.05),
                "b": _bf16_np(rng.standard_normal(c) * 0.01)}

    if convs_per_unit == 2:
        return [{"convs1": [conv(k) for _ in d], "convs2": [conv(k) for _ in d]}
                for k, d in zip(kernel_sizes, dilations)]
    return [{"convs": [conv(k) for _ in d]} for k, d in zip(kernel_sizes, dilations)]


def _bf16_stage(stage_np, geometry):
    ks, dils, cpu = geometry
    torch_stage = cast(params_from_jax({"resblocks": stage_np}, "hifi_gan")["resblocks"], BF16)
    return mrf_block.pack_mrf_stage(torch_stage, ks, dils, cpu)


def _pallas_mrf_bf16(x, stage_np, geometry):
    ks, dils, cpu = geometry
    weights = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), j_pack(stage_np))
    out = fused_mrf(jnp.asarray(x, jnp.bfloat16), weights, kernel_sizes=ks,
                    dilations_per_block=dils, tile=128, convs_per_unit=cpu, interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("channels", [32, 64, 128])
@pytest.mark.parametrize("geometry", [RESBLOCK1, RESBLOCK2], ids=["resblock1", "resblock2"])
def test_bf16_mrf_section_matches_pallas(channels, geometry):
    """The bf16 plain section (the wrapper on a CPU tensor) against fused_mrf
    in bf16, interpret mode, T = 300: <= 2 bf16 ULPs of the output's scale."""
    ks, dils, cpu = geometry
    rng = np.random.default_rng(200 + channels)
    stage_np = _random_stage(rng, channels, ks, dils, cpu)
    x = _bf16_np(rng.standard_normal((2, 300, channels)))
    ref = _pallas_mrf_bf16(x, stage_np, geometry)
    out = mrf_block.mrf_section(torch.from_numpy(x).to(BF16), _bf16_stage(stage_np, geometry))
    assert out.dtype == BF16 and out.shape == ref.shape
    assert _ulps_of_scale(out.float().numpy(), ref) <= ULPS


def _wn_layer_np(rng, ch, cc, rs_out):
    n = lambda shape, s: _bf16_np(rng.standard_normal(shape) * s)  # noqa: E731
    return dict(w_in=n((3, ch, 2 * ch), 0.05), b_in=n((2 * ch,), 0.01),
                w_cond=n((cc, 2 * ch), 0.05), b_cond=n((2 * ch,), 0.01),
                w_rs=n((ch, rs_out), 0.05), b_rs=n((rs_out,), 0.01))


def _wn_pack_bf16(layer_np):
    t = {k: torch.from_numpy(v).to(BF16) for k, v in layer_np.items()}
    return wn_layer.pack_wn_layer(
        t["w_in"].permute(2, 1, 0).contiguous(), t["b_in"], t["w_cond"].t().contiguous(),
        t["b_cond"], t["w_rs"].t().contiguous(), t["b_rs"],
    )


def _wn_jax_args(layer_np):
    return [jnp.asarray(layer_np[k], jnp.bfloat16)
            for k in ("w_in", "b_in", "w_cond", "b_cond", "w_rs", "b_rs")]


@pytest.mark.parametrize("mode,dilation", [("first", 1), ("middle", 4), ("last", 128),
                                           ("rs", 2)])
def test_bf16_wn_layer_matches_pallas(mode, dilation):
    """The bf16 plain WN layer (the wrappers on CPU tensors) against the
    Pallas kernels in bf16, interpret mode, at wn_256 width, T = 300: <= 2
    bf16 ULPs of each output's scale."""
    ch, cc, b, t = 256, 640, 2, 300
    first, last = mode == "first", mode == "last"
    rng = np.random.default_rng(300 + dilation)
    layer_np = _wn_layer_np(rng, ch, cc, ch if last else 2 * ch)
    h = _bf16_np(rng.standard_normal((b, t, ch)))
    cond = _bf16_np(rng.standard_normal((b, t, cc)))
    skip = _bf16_np(rng.standard_normal((b, t, ch)))
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    tb = lambda a: torch.from_numpy(a).to(BF16)  # noqa: E731
    layer = _wn_pack_bf16(layer_np)
    if mode == "rs":
        refs = [j_wn_layer(jb(h), jb(cond), *_wn_jax_args(layer_np), dilation=dilation, tile=128,
                           interpret=True)]
        outs = [wn_layer.fused_wn_layer(tb(h), tb(cond), layer, dilation)]
    else:
        refs = j_wn_layer_state(jb(h), jb(cond), None if first else jb(skip),
                                *_wn_jax_args(layer_np), dilation=dilation, first=first,
                                last=last, tile=128, interpret=True)
        outs = wn_layer.fused_wn_layer_state(tb(h), tb(cond), None if first else tb(skip), layer,
                                             dilation, first, last)
    for r, o in zip(refs, outs):
        assert o.dtype == BF16
        assert _ulps_of_scale(o.float().numpy(), np.asarray(r.astype(jnp.float32))) <= ULPS


_EXACTNESS_SCRIPT = r"""
import json, numpy as np, jax, jax.numpy as jnp, torch
from larynx_tpu.ops.mrf_block import fused_mrf, pack_mrf_weights
from larynx_tpu.ops.wn_layer import fused_wn_layer_state
from larynx_tpu_torch.ops import mrf_block, wn_layer
from larynx_tpu_torch.weights import cast, params_from_jax
import test_torch_mixed_precision as t

out = {}
geometry = ((3, 7), ((1, 3), (1, 3)), 2)
rng = np.random.default_rng(7)
stage_np = t._random_stage(rng, 32, *geometry)
x = t._bf16_np(rng.standard_normal((2, 300, 32)))
ref = t._pallas_mrf_bf16(x, stage_np, geometry)
got = mrf_block.mrf_section(torch.from_numpy(x).bfloat16(), t._bf16_stage(stage_np, geometry))
out["mrf"] = float(np.mean(got.float().numpy() == ref))

layer_np = t._wn_layer_np(rng, 256, 640, 512)
h, cond, skip = (t._bf16_np(rng.standard_normal((2, 300, c))) for c in (256, 640, 256))
jb = lambda a: jnp.asarray(a, jnp.bfloat16)
refs = fused_wn_layer_state(jb(h), jb(cond), jb(skip), *t._wn_jax_args(layer_np), dilation=4,
                            tile=128, interpret=True)
tb = lambda a: torch.from_numpy(a).bfloat16()
outs = wn_layer.fused_wn_layer_state(tb(h), tb(cond), tb(skip), t._wn_pack_bf16(layer_np), 4)
out["wn"] = min(float(np.mean(o.float().numpy() == np.asarray(r.astype(jnp.float32))))
                for o, r in zip(outs, refs))
print(json.dumps(out))
"""


def test_bf16_rounding_points_without_excess_precision():
    """With XLA's excess precision off, the bf16 plain versions reproduce the
    Pallas kernels' rounding: >= 99.9% of the elements exact."""
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests"),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", _EXACTNESS_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    exact = json.loads(proc.stdout.strip().splitlines()[-1])
    assert exact["mrf"] >= 0.999 and exact["wn"] >= 0.999, exact


# -----------------------------------------------------------------------------
# Weight layouts and the launch plan in bf16


@pytest.mark.parametrize("channels,geometry", [(8, RESBLOCK1), (32, RESBLOCK2), (64, RESBLOCK1),
                                               (128, RESBLOCK2)])
def test_pack_stages_bf16_decodes_to_the_weights(channels, geometry):
    """Every bf16 weight stage decodes back to the weights: element (tap,
    kstep, ngrp, khalf, r8, k8) of a conv's stages is W[tap][16*kstep +
    8*khalf + k8][8*ngrp + r8], and zero for the padded inputs at C=8."""
    ks, dils, cpu = geometry
    rng = np.random.default_rng(channels)
    stage = _bf16_stage(_random_stage(rng, channels, ks, dils, cpu), geometry)
    c, ck = channels, max(channels, 16)
    w_flat, wpack = stage.w_flat.float().numpy(), stage.wpack.float().numpy()
    assert stage.wpack.dtype == BF16
    assert wpack.size == w_flat.size * ck // c
    assert wpack.size * 2 % (32 * c) == 0  # whole 32*C-byte stages
    off = poff = 0
    for k, d in zip(ks, dils):
        for _ in range(len(d) * cpu):
            w = w_flat[off : off + k * c * c].reshape(k, c, c)  # [tap][C_in][C_out]
            v = wpack[poff : poff + k * ck * c].reshape(k, ck // 16, c // 8, 2, 8, 8)
            decoded = v.transpose(0, 1, 3, 5, 2, 4).reshape(k, ck, c)  # tap ks kh k8 ngrp r8
            np.testing.assert_array_equal(decoded[:, :c], w)
            assert not decoded[:, c:].any()
            off += w.size
            poff += k * ck * c


@pytest.mark.parametrize("rs_out", [512, 256])
def test_pack_weights_bf16_layout(rs_out):
    """The bf16 stage order (``_stages``), element by element: one plane,
    16-row k-steps, 16 KB stages.  Integer weights below 256 are exact in
    bf16, so each element names its source row and column."""
    ch, k = 256, 64
    rows = torch.arange(k, dtype=torch.float32)[:, None]
    cols = torch.arange(2 * ch, dtype=torch.float32)[None, :]
    w_a = (rows * 0 + cols % 128 + 0 * rows).to(BF16)  # column index mod 128
    w_a_rows = (rows + 0 * cols).to(BF16)  # row index
    packed_cols = wn_layer.pack_weights(w_a, torch.zeros((ch, rs_out), dtype=BF16))
    packed_rows = wn_layer.pack_weights(w_a_rows, torch.zeros((ch, rs_out), dtype=BF16))
    assert packed_cols.dtype == BF16
    assert packed_cols.numel() == k * 2 * ch + ch * rs_out
    assert packed_cols.numel() * 2 % wn_layer.STAGE_BYTES_BF16 == 0
    n = ch  # first product: each consumer's 256 columns
    kps = wn_layer.STAGE_BYTES_BF16 // (wn_layer.CONSUMERS * n * 16 * 2)
    n_a = k * 2 * ch
    vc = packed_cols[:n_a].float().reshape(-1, kps, wn_layer.CONSUMERS, n // 8, 2, 8, 8)
    vr = packed_rows[:n_a].float().reshape(-1, kps, wn_layer.CONSUMERS, n // 8, 2, 8, 8)
    half = ch // wn_layer.CONSUMERS
    for stage in (0, vc.shape[0] - 1):
        for c in range(wn_layer.CONSUMERS):
            for ngrp, kgrp, r8, k8 in ((0, 0, 0, 0), (5, 1, 3, 2), (n // 8 - 1, 1, 7, 7)):
                i = 8 * ngrp + r8
                col = c * half + i if i < half else ch + c * half + (i - half)
                assert vc[stage, 0, c, ngrp, kgrp, r8, k8].item() == col % 128
                assert vr[stage, 0, c, ngrp, kgrp, r8, k8].item() == 16 * stage + 8 * kgrp + k8
    # the second product: consumer c owns a contiguous half of rs
    w_rs = (torch.arange(rs_out, dtype=torch.float32)[None, :] % 128
            + 0 * torch.arange(ch, dtype=torch.float32)[:, None]).to(BF16)
    packed = wn_layer.pack_weights(torch.zeros((k, 2 * ch), dtype=BF16), w_rs)[n_a:].float()
    n2 = rs_out // wn_layer.CONSUMERS
    kps2 = wn_layer.STAGE_BYTES_BF16 // (wn_layer.CONSUMERS * n2 * 16 * 2)
    v = packed.reshape(-1, kps2, wn_layer.CONSUMERS, n2 // 8, 2, 8, 8)
    for c in range(wn_layer.CONSUMERS):
        for ngrp, r8 in ((0, 0), (n2 // 8 - 1, 7)):
            assert v[1, kps2 - 1, c, ngrp, 1, r8, 3].item() == (c * n2 + 8 * ngrp + r8) % 128


# (B, T) of the bf16 WN kernel's plan: the main path's group call, the B=1
# stacks of the server, the fallback, the trained voice and the mesh grid,
# a ragged T with an odd tile count (13 a row, 39 in all) and T under a tile
WN_PLAN_SHAPES = ([(4, 32768)] + [(1, t) for t in (2816, 8192, 12288, 14592, 16384, 24576, 32768)]
                  + [(3, 777), (1, 64 * 13 - 5), (2, 40), (1, 1)])


@pytest.mark.parametrize("b,t", WN_PLAN_SHAPES, ids=[f"B{b}-T{t}" for b, t in WN_PLAN_SHAPES])
@pytest.mark.parametrize("active", [66, 1])
def test_bf16_wn_launch_plan(b, t, active):
    """The bf16 WN kernel's plan (``csrc/wn_bf16.cu``, mirrored by
    ``bf16_launch_plan``): clusters of 2 blocks, at most as many as fit;
    walking items k, k + clusters, ... covers every 64-row tile once, the
    tiles past the last on batch rows >= B; the weight stages of a tile are
    the packed weights, and each leaves L2 once an item; the shared memory
    fits a block."""
    tiles_row = -(-t // 64)
    n = wn_layer.BF16_CLUSTER
    for rs_out in (512, 256):
        plan = wn_layer.bf16_launch_plan(b, t, 640, rs_out, active)
        assert plan["tiles"] == b * tiles_row and plan["cluster"] == n == 2
        assert plan["items"] == -(-plan["tiles"] // n)
        assert plan["clusters"] == min(plan["items"], active)
        assert plan["grid"] == n * plan["clusters"]
        seen = []
        for k in range(plan["clusters"]):
            walk = range(k, plan["items"], plan["clusters"])
            assert len(walk) <= plan["tiles_per_block"]
            seen += [item * n + rank for item in walk for rank in range(n)]
        assert sorted(seen) == list(range(plan["items"] * n))
        assert all(tile // tiles_row >= b for tile in seen if tile >= plan["tiles"])
        assert max(len(range(k, plan["items"], plan["clusters"]))
                   for k in range(plan["clusters"])) == plan["tiles_per_block"]
        w = torch.zeros((3 * 256 + 640, 512), dtype=BF16)
        wpack = wn_layer.pack_weights(w, torch.zeros((256, rs_out), dtype=BF16))
        assert plan["stages_per_tile"] * plan["stage_bytes"] == 2 * wpack.numel()
        assert plan["stages_per_tile"] == 88 + (16 if rs_out == 512 else 8)
        assert plan["l2_weight_bytes"] == plan["items"] * 2 * wpack.numel()
        assert plan["ring_stages"] == 8 and plan["stage_bytes"] == 16384
        assert (12 * wn_layer.BF16_CHUNK_BYTES + plan["ring_stages"] * plan["stage_bytes"]
                < plan["smem_bytes"] == 230616 <= mrf_block.MAX_SMEM)
    if (b, t, active) == (4, 32768, 66):  # the main path: 16 tiles a block, 1.74 GB from L2
        main = wn_layer.bf16_launch_plan(b, t, 640, 512, 66)
        assert (main["grid"], main["tiles_per_block"]) == (132, 16)
        assert main["l2_weight_bytes"] == 1744830464


def test_bf16_wn_launch_plan_rejects_what_the_kernel_does_not_take():
    for args in ((0, 10, 640, 512), (65536, 10, 640, 512), (1, 0, 640, 512), (1, 10, 32, 512),
                 (1, 10, 640, 384)):
        with pytest.raises(ValueError):
            wn_layer.bf16_launch_plan(*args, active_clusters=66)


def _gate_closed_form(a, b):
    """The bf16 WN kernel's gate, csrc/wn_bf16.cu::gate, with exact exp2
    and division: (1 - e^-2a) / ((1 + e^-2a)(1 + e^-b)), a clamped to
    [-9, 9]."""
    log2e = 1.4426950408889634
    a = a.clamp(-9.0, 9.0)
    ea = torch.exp2(-2.0 * log2e * a)
    eb = torch.exp2(-log2e * b)
    return (1.0 - ea) * (1.0 / ((1.0 + ea) * (1.0 + eb)))


def test_bf16_wn_gate_closed_form():
    """The kernel's form of tanh(a) * sigmoid(b), in float64, stays within
    3.1e-8 of tanh(a) * sigmoid(b) (the clamp's tanh(9) = 1 - 3.05e-8) over
    the range the pre-gate takes and far past it (|a|, |b| up to 1e4 at
    float32 values: the clamp keeps e^-2a finite, an infinite e^-b gives
    0), and rounds to the same bf16 gate but for a few ties."""
    v = torch.cat([torch.linspace(-12, 12, 2401), torch.tensor([-1e4, -100.0, -30.0, 30.0, 100.0,
                                                                  1e4, 0.0, 1e-6, -1e-6])])
    a, b = torch.meshgrid(v.double(), v.double(), indexing="ij")
    got, want = _gate_closed_form(a, b), torch.tanh(a) * torch.sigmoid(b)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() < 3.1e-8
    assert (got.to(BF16) != want.to(BF16)).float().mean().item() < 1e-3


# Released geometries: (vocoder, C, ResBlock geometry); every one of them
# runs the bf16 kernel (universal_large stages 2-4, vctk_medium 1-4,
# vctk_small 1-4).
RELEASED = [(name, c, geometry) for name, cs, geometry in (
    ("universal_large", (128, 64, 32), RESBLOCK1),
    ("vctk_medium", (64, 32, 16, 8), RESBLOCK1),
    ("vctk_small", (128, 64, 32, 16), RESBLOCK2),
) for c in cs]


@pytest.mark.parametrize("name,channels,geometry", RELEASED,
                         ids=[f"{n}-C{c}" for n, c, _g in RELEASED])
def test_bf16_geometry_fits(name, channels, geometry):
    """The bf16 kernel's shared-memory budget (``csrc/mrf_bf16.cu``,
    mirrored): every released geometry fits a block's 227 KB with a ring of
    at least 4 weight stages.  A C <= 64 section tile: 256 output rows, the
    section's halo (60 rows for universal_large's ResBlock1, 45 for
    vctk_small's ResBlock2) on each side, half an SM at C <= 32.  A C = 128
    unit block: 256 first-conv rows, 256 - (k - 1) output rows."""
    ks, dils, cpu = geometry
    if mrf_block.bf16_plan(channels) == "section":
        tiles = [mrf_block.bf16_tile(channels, ks, dils, cpu)]
        halo = max(mrf_block.chain_halo(k, d, cpu) for k, d in zip(ks, dils))
        assert tiles[0][:2] == (256, halo) and halo == (60 if cpu == 2 else 45)
    else:
        tiles = [mrf_block.bf16_tile(channels, (k,), ((d,),), cpu) for k, dd in zip(ks, dils)
                 for d in dd]
        assert [r for r, _s, _p in tiles] == [256 - (k - 1 if cpu == 2 else 0) for k, dd in
                                            zip(ks, dils) for _d in dd]
    for r, s, p in tiles:
        smem = mrf_block.bf16_smem_bytes(channels, r, p)
        assert p == (r + 2 * s + 15) // 16 * 16 and p // 2 <= mrf_block.MAX_ROWS
        assert mrf_block.bf16_fits(channels, r, p)
        assert mrf_block.bf16_ring_stages(channels, r, p) >= 4
        assert smem <= (mrf_block.PAIR_SMEM if channels <= 32 else mrf_block.MAX_SMEM)


def test_bf16_smem_bytes():
    """C=64, universal_large: 1 KB slack + the header (34 barriers, the
    chains' 128 B, 32 convs' biases; padded to 128 B) + H and A (8 planes
    each of 384 rows x 16 B) + the f32 chain sum (256 x 64 x 4), then 8 KB
    weight stages (a tap's four k-steps): 7.  C=32: half an SM, 2 KB stages
    (a tap).  C=8: A padded to two planes, 256 B stages.  C=128 (11, 5): H
    and A of 320 rows, two convs' biases, no chain sum in shared memory,
    8 KB stages (two k-steps)."""
    header = lambda c, convs: (8 * 34 + 128 + convs * c * 2 + 127) // 128 * 128  # noqa: E731
    fixed = 1024 + header(64, 32) + 16 * 384 * 16 + 256 * 64 * 4
    assert header(64, 32) == 4608
    assert mrf_block.bf16_ring_stages(64, 256, 384) == (mrf_block.MAX_SMEM - fixed) // 8192 == 7
    assert mrf_block.bf16_smem_bytes(64, 256, 384) == fixed + 7 * 8192
    fixed32 = 1024 + header(32, 32) + 8 * 384 * 16 + 256 * 32 * 4
    assert mrf_block.bf16_ring_stages(32, 256, 384) == (mrf_block.PAIR_SMEM - fixed32) // 2048
    assert mrf_block.bf16_smem_bytes(8, 256, 384) == (1024 + header(8, 32) + 3 * 384 * 16
                                                      + 256 * 8 * 4 + 16 * 256)
    assert mrf_block.bf16_tile(128, (11,), ((5,),)) == (246, 30, 320)
    fixed128 = 1024 + header(128, 2) + 32 * 320 * 16
    assert mrf_block.bf16_smem_bytes(128, 246, 320) == fixed128 + 8 * 8192 <= mrf_block.MAX_SMEM
    # a section halo past 160 rows leaves no 64-row output block
    assert mrf_block.bf16_tile(32, (3,), ((80, 80),)) == (0, 162, 336)
    assert not mrf_block.bf16_fits(32, 0, 336)


def test_bf16_launch_plan():
    """bf16: one launch per section at C <= 64, one per unit at C = 128,
    where the unit plan's weight offsets step by one bf16 plane (half the
    float32 plan's, over 16-channel inputs at C=8); float32: one per unit.
    universal_large's generator makes 9 + 1 + 1 launches in bf16, 27 in
    float32."""
    gen = torch.Generator().manual_seed(0)

    def stage(c, dtype):
        conv = lambda k: {"w": torch.randn((c, c, k), generator=gen),  # noqa: E731
                          "b": torch.randn(c, generator=gen)}
        blocks = [{"convs1": [conv(k) for _ in range(3)], "convs2": [conv(k) for _ in range(3)]}
                  for k in (3, 7, 11)]
        return mrf_block.pack_mrf_stage(cast(blocks, dtype))

    assert [mrf_block.bf16_plan(c) for c in (8, 16, 32, 64, 128)] == ["section"] * 4 + ["units"]
    units = [len(mrf_block.unit_launches(stage(c, BF16))) for c in (128, 64, 32)]
    assert units == [9, 9, 9]
    assert sum(1 if mrf_block.bf16_plan(c) == "section" else n
               for c, n in zip((128, 64, 32), units)) == 9 + 1 + 1
    f32, bf16 = stage(8, torch.float32), stage(8, BF16)
    p32, p16 = mrf_block.unit_launches(f32), mrf_block.unit_launches(bf16)
    assert [p[:4] + p[5:] for p in p32] == [p[:4] + p[5:] for p in p16]
    assert [p[4] for p in p16] == [p[4] * 16 // (2 * 8) for p in p32]
    assert p16[-1][4] + 2 * 11 * 16 * 8 == bf16.wpack.numel()


def _conv_rows(a, w, bias, dd, lo, hi, pos, inside, t):
    """Rows [lo, hi) of one conv over a tile buffer ``a`` [B, P, C] whose
    row j holds position ``pos[j]``: the buffer's rows inside [0, T) placed
    at their positions in a sequence of NaN (so a row read outside the ones
    given shows), the conv taken there with F.conv1d as the plain version
    takes it (the same shapes, so the same float32 sums), rounded to bf16
    and zero outside [0, T)."""
    b, _p, c = a.shape
    half = (w.shape[-1] - 1) // 2
    seq = torch.full((b, t, c), float("nan"))
    seq[:, pos[inside]] = a[:, inside]
    y = torch.nn.functional.conv1d(seq.transpose(1, 2), w, bias, padding=half * dd,
                                   dilation=dd).transpose(1, 2)
    out = torch.zeros((b, hi - lo, c))
    keep = inside[lo:hi]
    out[:, keep] = y[:, pos[lo:hi][keep]].to(BF16).float()
    return out


def _tiled_chains(x: torch.Tensor, stage: mrf_block.MRFStage, r_rows: int, s: int,
                  short: int = 0):
    """The bf16 kernel's plan on the CPU, tile by tile: each tile of
    ``r_rows`` output rows loads the positions [t0 - s, t0 - s + P) (zero
    outside [0, T)) once per chain; each conv computes only the rows that
    the chain's later convs still need (its halo less what it used), every
    other row of its output NaN; each conv's output is zeroed outside [0, T)
    and rounded to bf16, the leaky-ReLU is JAX's bf16 one, h + conv is
    rounded.  ``short`` computes that many rows fewer on each side of every
    conv.  Returns each chain's output [B, T, C] (bf16 values in
    float32)."""
    b, t, c = x.shape
    ks, dils, cpu = stage.kernel_sizes, stage.dilations_per_block, stage.convs_per_unit
    p = (r_rows + 2 * s + 15) // 16 * 16
    units = list(mrf_block._unpacked_convs(stage.w_flat, stage.b_flat, c, ks, dils, cpu))
    lrelu = lambda v: torch.where(v >= 0, v, (v * mrf_block.LRELU_SLOPE_BF16).to(BF16).float())  # noqa: E731,E501
    outs = [torch.full((b, t, c), float("nan")) for _ in ks]
    for t0 in range(0, t, r_rows):
        pos = torch.arange(t0 - s, t0 - s + p)
        inside = (pos >= 0) & (pos < t)
        tile = torch.zeros((b, p, c))
        tile[:, inside] = x.float()[:, pos[inside]]
        for r, (k, d) in enumerate(zip(ks, dils)):
            half = (k - 1) // 2
            rem = mrf_block.chain_halo(k, d, cpu) - short
            h = tile.clone()
            for _r, _u, convs in (u for u in units if u[0] == r):
                a = lrelu(h)
                for i, (w, bias, dd) in enumerate(convs):
                    rem -= half * dd
                    lo, hi = s - rem, s + r_rows + rem
                    y = _conv_rows(a, w.float(), bias.float(), dd, lo, hi, pos, inside, t)
                    if i < len(convs) - 1:
                        a = torch.full_like(a, float("nan"))
                        a[:, lo:hi] = lrelu(y)
                    else:
                        hn = torch.full_like(h, float("nan"))
                        hn[:, lo:hi] = (h[:, lo:hi] + y).to(BF16).float()
                        h = hn
            n = min(r_rows, t - t0)
            outs[r][:, t0 : t0 + n] = h[:, s : s + n]
    return outs


@pytest.mark.parametrize("b,t", [(1, 2 * 256 + 100), (3, 100)], ids=["B1-T612", "B3-T100"])
@pytest.mark.parametrize("channels", [8, 32, 64])
@pytest.mark.parametrize("geometry", [RESBLOCK1, RESBLOCK2], ids=["resblock1", "resblock2"])
def test_bf16_section_tiles_compose_to_the_section(geometry, channels, b, t):
    """The bf16 section plan (C <= 64) on the CPU, tile by tile
    (:func:`_tiled_chains` at the kernel's ``bf16_tile``): three tiles of
    256 rows for T = 612, the last ragged, or one tile longer than T = 100;
    the chains' sum in float32, divided by n_chains and rounded once: bit
    for bit the plain section, which the tests above hold against fused_mrf.
    No NaN survives, so no conv read a row outside the halo it was given."""
    ks, dils, cpu = geometry
    rng = np.random.default_rng(400 + channels + t)
    stage = _bf16_stage(_random_stage(rng, channels, ks, dils, cpu), geometry)
    x = torch.from_numpy(_bf16_np(rng.standard_normal((b, t, channels)))).to(BF16)
    r_rows, s, _p = mrf_block.bf16_tile(channels, ks, dils, cpu)
    assert r_rows == 256 and (t - 1) // r_rows + 1 == (3 if t > 256 else 1)
    chains = _tiled_chains(x, stage, r_rows, s)
    total = chains[0]
    for h in chains[1:]:
        total = total + h
    out = (total / len(ks)).to(BF16)
    assert not torch.isnan(out.float()).any()
    plain = mrf_block.mrf_section_plain(x, stage.w_flat, stage.b_flat, ks, dils, cpu)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


def test_bf16_section_tiles_need_the_whole_halo():
    """The emulation catches a halo one row short: a conv then reads a row
    that no conv before it computed, and NaN reaches the output."""
    ks, dils, cpu = RESBLOCK1
    rng = np.random.default_rng(5)
    stage = _bf16_stage(_random_stage(rng, 32, ks, dils, cpu), RESBLOCK1)
    x = torch.from_numpy(_bf16_np(rng.standard_normal((1, 600, 32)))).to(BF16)
    r_rows, s, _p = mrf_block.bf16_tile(32, ks, dils, cpu)
    assert not torch.isnan(_tiled_chains(x, stage, r_rows, s)[-1]).any()
    assert torch.isnan(_tiled_chains(x, stage, r_rows, s, short=1)[-1]).any()


@pytest.mark.parametrize("geometry", [RESBLOCK1, RESBLOCK2], ids=["resblock1", "resblock2"])
def test_bf16_units_compose_to_the_section(geometry):
    """The bf16 unit plan (C = 128) on the CPU: each unit launch tile by
    tile (:func:`_tiled_chains` on a one-unit stage at the kernel's
    ``bf16_tile``: 256 first-conv rows, 256 - (k - 1) output rows), x or a
    scratch buffer in and out; a chain's last unit stores or adds into a
    float32 sum, and the last chain's writes that sum / n_chains rounded
    once: bit for bit the plain section."""
    ks, dils, cpu = geometry
    rng = np.random.default_rng(11)
    stage = _bf16_stage(_random_stage(rng, 128, ks, dils, cpu), geometry)
    x = torch.from_numpy(_bf16_np(rng.standard_normal((2, 300, 128)))).to(BF16)
    convs = list(mrf_block._unpacked_convs(stage.w_flat, stage.b_flat, 128, ks, dils, cpu))
    buffers = {"x": x}
    total = None
    for (r, _u, k, d, _w, b_row, src, dst, mode, _scale), (_r, _u2, unit) in zip(
            mrf_block.unit_launches(stage), convs):
        one = mrf_block.MRFStage(
            torch.cat([w.permute(2, 1, 0).reshape(-1) for w, _b, _d in unit]),
            stage.b_flat[b_row : b_row + cpu], None, (k,), ((d,),), cpu)
        r_rows, s, _p = mrf_block.bf16_tile(128, (k,), ((d,),), cpu)
        assert r_rows == 256 - (k - 1 if cpu == 2 else 0)
        h_new = _tiled_chains(buffers[src], one, r_rows, s)[0]
        assert h_new.equal(mrf_block.mrf_unit_plain(buffers[src], unit).float())
        if mode == mrf_block.MODE_TO_SCRATCH:
            buffers[dst] = h_new.to(BF16)
            continue
        total = h_new if mode == mrf_block.MODE_OUT_STORE else total + h_new
        if r == len(ks) - 1:
            buffers[dst] = (total / len(ks)).to(BF16)
    plain = mrf_block.mrf_section_plain(x, stage.w_flat, stage.b_flat, ks, dils, cpu)
    torch.testing.assert_close(buffers["out"], plain, rtol=0, atol=0)


# -----------------------------------------------------------------------------
# Models in bf16 against the JAX package's


def test_bf16_generator_matches_jax():
    """The HiFi-GAN generator in bf16 (stages of C = 32, 16, 8, 4: the MRF
    sections through the bf16 plain version) against the JAX generator in
    bf16 with its Pallas kernels in interpret mode, and against its own f32
    run: the end-to-end bar on the float audio."""
    cfg = dict(upsample_initial_channel=64)
    params_np = jax.tree.map(np.asarray, j_hifi_init(jax.random.PRNGKey(4), JHiFiGanConfig(**cfg)))
    mel = np.random.default_rng(5).uniform(-4, 1, size=(2, 16, 80)).astype(np.float32)
    bf = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params_np)
    ref = j_hifi.generator(bf, JHiFiGanConfig(**cfg), jnp.asarray(mel, jnp.bfloat16),
                           use_pallas=True, pallas_interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    tparams = params_from_jax(params_np, "hifi_gan")
    tcfg = HiFiGanConfig(**cfg)
    out = t_hifi.generator(t_hifi.pack_params(cast(tparams, BF16), tcfg), tcfg,
                           torch.from_numpy(mel).to(BF16))
    f32 = t_hifi.generator(t_hifi.pack_params(tparams, tcfg), tcfg, torch.from_numpy(mel))
    assert out.dtype == BF16 and out.shape == ref.shape == (2, 16 * 256)
    out = out.float().numpy()
    assert _corr(out, ref) > CORRELATION and _corr(out, f32.numpy()) > CORRELATION
    assert abs(_rms(out) - _rms(ref)) < 0.01 * np.abs(ref).max()


def test_bf16_waveglow_infer_matches_jax():
    """WaveGlow ``infer`` in bf16 (mel, prior, WN layers, couplings and the
    invertible 1x1s) against the JAX package's in bf16 (Pallas WN kernels in
    interpret mode), and no further from its own f32 run than the JAX
    package's bf16 run is from its f32 run."""
    from test_torch_waveglow import _perturbed_params

    jcfg, tcfg = JWaveGlowConfig(**WG_SMALL), WaveGlowConfig(**WG_SMALL)
    tree = _perturbed_params(jcfg, 6)
    rng = np.random.default_rng(7)
    m = 6
    mel = rng.standard_normal((2, m, jcfg.mel_channels)).astype(np.float32)
    z = (rng.standard_normal((2, m * jcfg.upsample_stride // jcfg.groups, jcfg.groups))
         * 0.9).astype(np.float32)

    def jax_run(dtype):
        params = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
        out = jwg.infer(params, jcfg, jnp.asarray(mel, dtype), z=jnp.asarray(z, dtype),
                        use_pallas=True, pallas_interpret=True)
        return np.asarray(out.astype(jnp.float32))

    def port_run(dtype):
        params = twg.pack_params(cast(params_from_jax(tree, "waveglow"), dtype), tcfg)
        out = twg.infer(params, tcfg, torch.from_numpy(mel).to(dtype), z=torch.from_numpy(z).to(dtype))
        assert out.dtype == dtype
        return out.float().numpy()

    ref16, ref32, out16, out32 = jax_run(jnp.bfloat16), jax_run(jnp.float32), port_run(BF16), \
        port_run(torch.float32)
    rel = lambda a, b: _rms(a - b) / _rms(b)  # noqa: E731
    assert rel(out16, out32) <= 1.1 * rel(ref16, ref32), (rel(out16, out32), rel(ref16, ref32))
    assert _corr(out16, ref16) > CORRELATION


def _inject_noise(monkeypatch, noise_np):
    """Both packages' GlowTTS decode draw their latent from ``noise_np``
    (sliced to the draw's shape) instead of their own generators."""
    real_normal = jax.random.normal

    def j_normal(key, shape, dtype=jnp.float32):
        if len(shape) == 3:
            b, m, c = shape
            return jnp.asarray(noise_np[:b, :m, :c], dtype)
        return real_normal(key, shape, dtype)

    monkeypatch.setattr(jax.random, "normal", j_normal)
    real_decode = t_glow.expand_and_decode

    def t_decode(*args, **kwargs):
        b, _t, c = args[2].shape
        m = kwargs["mel_max_length"]
        kwargs["noise"] = torch.from_numpy(noise_np[:b, :m, :c].copy())
        kwargs["generator"] = None
        return real_decode(*args, **kwargs)

    monkeypatch.setattr(tengine.glow_model, "expand_and_decode", t_decode)


def test_vocoder_half_engine_matches_jax(small_models, monkeypatch):
    """``synthesize_batch`` with ``vocoder_half=True`` (f32 flows, bf16
    HiFi-GAN) against the JAX engine's, the same latent noise injected on
    both sides, and against the port's own f32 engine: the end-to-end bar."""
    noise = np.random.default_rng(9).standard_normal((8, 512, 80)).astype(np.float32)
    _inject_noise(monkeypatch, noise)
    rng = np.random.default_rng(3)
    ids = [rng.integers(1, 46, size=n).astype(np.int64) for n in (24, 17)]
    ref = _jax_engine(small_models, vocoder_half=True).synthesize_batch(ids, seed=7)
    out = _port_engine(small_models, vocoder_half=True).synthesize_batch(ids, seed=7)
    f32 = _port_engine(small_models, vocoder_half=False).synthesize_batch(ids, seed=7)
    for r, o, f in zip(ref, out, f32):
        assert o.dtype == np.int16 and np.abs(o.astype(np.int32)).max() > 1000
        _audibly_identical(o, r)
        _audibly_identical(o, f)


def test_half_glow_tts_matches_jax(small_models):
    """GlowTTS in bf16 (``half``): encode against the JAX package's bf16
    encode, then the reverse flow at the JAX side's durations with the same
    latent noise: the mels by the end-to-end bar; the attention and the
    invertible 1x1 accumulate in f32, the durations stay f32."""
    glow_np, _ = small_models
    jcfg, tcfg = config_from_voice_json(VOICE_CONFIG), t_glow_config(VOICE_CONFIG)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), glow_np)
    tparams = cast(params_from_jax(glow_np, "glow_tts"), BF16)
    rng = np.random.default_rng(12)
    ids = rng.integers(1, 46, size=(2, 30)).astype(np.int64)
    lengths = np.array([30, 21], dtype=np.int64)
    j_enc = j_glow.encode(jparams, jcfg, jnp.asarray(ids), jnp.asarray(lengths), length_scale=1.0)
    t_enc = t_glow.encode(tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(lengths), 1.0)
    assert t_enc[0].dtype == BF16 and t_enc[3].dtype == torch.float32
    for j, t in zip(j_enc[:3], t_enc[:3]):  # x_m, x_logs, logw
        j = np.asarray(j.astype(jnp.float32))
        if np.abs(j).max() > 0:
            assert _corr(t.float().numpy(), j) > CORRELATION

    x_m, x_logs, _logw, w_ceil, y_lengths, _mask = j_enc
    m = int(-(-int(np.asarray(y_lengths).max()) // 8) * 8)
    noise = rng.standard_normal((2, m, 80)).astype(np.float32)
    key = jax.random.PRNGKey(0)

    def j_normal(k, shape, dtype=jnp.float32):
        return jnp.asarray(noise, dtype)

    real = jax.random.normal
    jax.random.normal = j_normal
    try:
        ref, _ = j_glow.expand_and_decode(jparams, jcfg, x_m, x_logs, w_ceil, y_lengths, key,
                                          mel_max_length=m, noise_scale=0.667)
    finally:
        jax.random.normal = real
    tt = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32)))  # noqa: E731
    out, z_mask = t_glow.expand_and_decode(
        tparams, tcfg, tt(x_m).to(BF16), tt(x_logs).to(BF16), tt(w_ceil),
        torch.from_numpy(np.asarray(y_lengths)), m, noise_scale=0.667,
        noise=torch.from_numpy(noise))
    assert out.dtype == BF16 and z_mask.dtype == BF16
    ref = np.asarray(ref.astype(jnp.float32))
    assert _corr(out.float().numpy(), ref) > CORRELATION
    assert abs(_rms(out.float().numpy()) - _rms(ref)) < 0.01 * np.abs(ref).max()


# -----------------------------------------------------------------------------
# Entry points with half


def _tts(module, voices_dir, **kwargs):  # noqa: F811
    extra = {"device": "cpu"} if module is larynx_tpu_torch else {}
    return [r.audio for r in module.text_to_speech(
        TEXT, voice_or_lang=VOICE, vocoder_or_quality=VOCODER, custom_voices_dir=voices_dir,
        no_download=True, tts_settings={"noise_scale": 0.0}, **kwargs, **extra)]


@pytest.fixture(scope="module")
def tts_runs(voices_dir):  # noqa: F811
    """``text_to_speech``'s audio of TEXT from both packages, with ``half``
    and in float32, each run once for the tests that compare against it."""
    return {"out": _tts(larynx_tpu_torch, voices_dir, half=True),
            "ref": _tts(larynx_tpu, voices_dir, half=True),
            "f32": _tts(larynx_tpu_torch, voices_dir),
            "ref32": _tts(larynx_tpu, voices_dir)}


def test_text_to_speech_half_matches_jax(voices_dir, tts_runs):  # noqa: F811
    """``text_to_speech(half=True)`` runs GlowTTS and the vocoder in bf16,
    each sentence as long as its own bf16 durations give, and agrees with
    the JAX package's half run (``_half_agrees``: here a flipped frame in
    one sentence).  Against its own f32 run it is held to the JAX package's
    own half-vs-f32 distance: bf16 GlowTTS moves the mel itself (the JAX
    package's correlation there is ~0.9988, under the vocoder's 0.999)."""
    out, ref, f32, ref32 = (tts_runs[k] for k in ("out", "ref", "f32", "ref32"))
    assert len(out) == len(ref) == len(f32) == len(ref32) == 2
    engines = [e for key, e in larynx_tpu_torch._ENGINE_CACHE.items() if key[3]]
    assert engines and all(e.dtype == BF16 and e.voc_dtype == BF16 for e in engines)
    jobs = larynx_tpu_torch._build_jobs(TEXT, VOICE, VOCODER, custom_voices_dir=voices_dir,
                                        no_download=True)
    enc, _ = engines[0].encode_launch([j["ids"] for j in jobs])
    y_lengths = enc[4].numpy()[: len(jobs)]
    compared = 0
    for o, r, f, r32, y in zip(out, ref, f32, ref32, y_lengths):
        assert o.dtype == np.int16 and o.shape == (int(y) * 256,)
        assert np.abs(o.astype(np.int32)).max() > 1000
        _half_agrees(o, r)
        _half_agrees(o, f, correlation=None)
        if o.shape == f.shape and r.shape == r32.shape:
            assert 1 - _corr(o, f) <= 1.1 * (1 - _corr(r, r32)), (_corr(o, f), _corr(r, r32))
            compared += 1
    assert compared


def test_stream_text_to_speech_half(voices_dir, tts_runs):  # noqa: F811
    """``stream_text_to_speech(half=True)``: the bf16 chunks against the JAX
    package's half stream and against the port's own f32 stream
    (``_half_agrees``), and against the port's half batch path."""
    def stream(module, **kwargs):
        extra = {"device": "cpu"} if module is larynx_tpu_torch else {}
        chunks = module.stream_text_to_speech(
            TEXT, voice_or_lang=VOICE, vocoder_or_quality=VOCODER, custom_voices_dir=voices_dir,
            tts_settings={"noise_scale": 0.0}, chunk_frames=16, **kwargs, **extra)
        return np.concatenate(list(chunks))

    out = stream(larynx_tpu_torch, half=True, no_download=True)
    ref = stream(larynx_tpu, half=True)
    f32 = stream(larynx_tpu_torch, no_download=True)
    assert out.dtype == np.int16 and np.abs(out.astype(np.int32)).max() > 300
    _half_agrees(out, ref)
    _half_agrees(out, f32, correlation=None)
    # the same bf16 durations and audio as the batch path (which peak-normalises)
    batch = np.concatenate(tts_runs["out"])
    assert batch.shape == out.shape and _corr(batch, out) > 0.9999


def test_cli_half(voices_dir, capsysbinary):  # noqa: F811
    """``python -m larynx_tpu_torch --half`` (in process, on the CPU): the
    WAV is the library's ``half=True`` audio, and meets the end-to-end bar
    against the JAX CLI's ``--half``.  The small vocoder is staged under the
    "low" preset's name, as in ``tests/test_torch_cli.py``."""
    low = voices_dir / "hifi_gan" / "vctk_small"
    if not low.exists():
        low.symlink_to(voices_dir / VOCODER)
    for module in (larynx_tpu, larynx_tpu_torch):
        module._VOCODER_MODEL_CACHE.pop("low", None)
    text = "The birch canoe slid on the smooth planks."
    argv = [text, "--voice", VOICE, "--quality", "low", "--voices-dir", str(voices_dir),
            "--noise-scale", "0", "--denoiser-strength", "0", "--half"]
    cli.main(argv + ["--device", "cpu", "--no-download"])
    rate, got = wavfile.read(io.BytesIO(capsysbinary.readouterr().out))
    jcli.main(argv)
    _rate, want = wavfile.read(io.BytesIO(capsysbinary.readouterr().out))
    lib = next(iter(larynx_tpu_torch.text_to_speech(
        text, voice_or_lang=VOICE, vocoder_or_quality="low", custom_voices_dir=voices_dir,
        no_download=True, tts_settings={"noise_scale": 0.0}, half=True, device="cpu"))).audio
    assert rate == 22050
    np.testing.assert_array_equal(got, lib)
    _half_agrees(got, want)


# -----------------------------------------------------------------------------
# The denoiser bias: built once, under a lock, in the vocoder's dtype


def test_bias_spec_built_once_under_threads(small_models, monkeypatch):
    """Many threads ask a fresh engine for its denoiser bias at once: it is
    computed once, and every thread gets that one tensor."""
    engine = _port_engine(small_models, vocoder_half=True)
    calls = []
    real = engine._compute_bias_spec

    def slow():
        calls.append(threading.get_ident())
        time.sleep(0.2)  # a window for every other thread to arrive
        return real()

    monkeypatch.setattr(engine, "_compute_bias_spec", slow)
    barrier = threading.Barrier(16, timeout=60)
    got = []

    def ask():
        barrier.wait()
        got.append(engine._get_bias_spec())

    threads = [threading.Thread(target=ask) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert len(calls) == 1 and len(got) == 16
    assert all(g is got[0] for g in got)
    assert got[0].dtype == torch.float32 and torch.isfinite(got[0]).all()
    # the bias comes from the engine's own bf16 vocoder: not the f32 one's
    f32 = _port_engine(small_models, vocoder_half=False)._get_bias_spec()
    assert not torch.equal(got[0], f32)
