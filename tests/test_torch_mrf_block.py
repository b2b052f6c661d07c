"""The port's MRF section as the CUDA kernel runs it: one resblock unit at a time.

``mrf_section`` launches ``csrc/mrf_section.cu`` once per resblock unit on
CUDA.  Here, on the CPU, the same plan (:func:`mrf_block.unit_launches`:
sources, destinations, output modes and scales) is composed from
``mrf_unit_plain`` and held against ``mrf_section_plain`` and against the
JAX Pallas kernel ``fused_mrf`` in interpret mode, at C in {32, 64, 128},
ResBlock1 and ResBlock2, with T = 300, not a multiple of any output stride
(126, 122, 118 for ResBlock1; 128 for ResBlock2).  Also here: the kernel's
weight stages (exact TF32 hi/lo planes in wgmma operand order) and the
tile geometry the wrapper hands the kernel.

Tolerances, float32: 1e-4 absolute against Pallas (12-18 chained convs of
up to 11*128 products summed in other orders, as in test_pallas_ops);
1e-5 against the plain section, which runs the same convs in the same
order and differs only in how the chain sums are formed (the last chain's
``(out + h) * (1/n)`` against ``(out + h) / n``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larynx_tpu.ops.mrf_block import fused_mrf
from larynx_tpu.ops.mrf_block import pack_mrf_weights as j_pack
from larynx_tpu_torch.ops import mrf_block
from larynx_tpu_torch.weights import params_from_jax

RESBLOCK1 = ((3, 7, 11), ((1, 3, 5),) * 3, 2)  # universal_large
RESBLOCK2 = ((3, 5, 7), ((1, 2), (2, 6), (3, 12)), 1)  # vctk_small


def _random_stage(rng, c, kernel_sizes, dilations, convs_per_unit):
    """JAX-layout resblock dicts (convs [k, C_in, C_out])."""
    def conv(k):
        return {
            "w": rng.standard_normal((k, c, c)).astype(np.float32) * 0.05,
            "b": rng.standard_normal(c).astype(np.float32) * 0.01,
        }

    if convs_per_unit == 2:
        return [{"convs1": [conv(k) for _ in d], "convs2": [conv(k) for _ in d]}
                for k, d in zip(kernel_sizes, dilations)]
    return [{"convs": [conv(k) for _ in d]} for k, d in zip(kernel_sizes, dilations)]


def _packed(stage_np, geometry):
    ks, dils, cpu = geometry
    torch_stage = params_from_jax({"resblocks": stage_np}, "hifi_gan")["resblocks"]
    return mrf_block.pack_mrf_stage(torch_stage, ks, dils, cpu)


def _units_composed(x: torch.Tensor, stage: mrf_block.MRFStage) -> torch.Tensor:
    """The kernel's launch plan, each launch as mrf_unit_plain plus its
    output mode."""
    c = x.shape[-1]
    convs = list(mrf_block._unpacked_convs(stage.w_flat, stage.b_flat, c, stage.kernel_sizes,
                                           stage.dilations_per_block, stage.convs_per_unit))
    plan = mrf_block.unit_launches(stage)
    assert [p[:2] for p in plan] == [u[:2] for u in convs]
    buffers = {"x": x}
    for (_r, _u, _k, _d, _w, _b, src, dst, mode, scale), (_r2, _u2, unit) in zip(plan, convs):
        h_new = mrf_block.mrf_unit_plain(buffers[src], unit)
        if mode == mrf_block.MODE_TO_SCRATCH:
            buffers[dst] = h_new
        elif mode == mrf_block.MODE_OUT_STORE:
            buffers[dst] = h_new * scale
        else:
            buffers[dst] = (buffers[dst] + h_new) * scale
    return buffers["out"]


@pytest.mark.parametrize("channels", [32, 64, 128])
@pytest.mark.parametrize("geometry", [RESBLOCK1, RESBLOCK2], ids=["resblock1", "resblock2"])
def test_mrf_units_compose_to_the_pallas_section(channels, geometry):
    ks, dils, cpu = geometry
    rng = np.random.default_rng(100 + channels)
    stage_np = _random_stage(rng, channels, ks, dils, cpu)
    x = rng.standard_normal((2, 300, channels)).astype(np.float32)
    ref = np.asarray(fused_mrf(jnp.asarray(x), j_pack(stage_np), kernel_sizes=ks,
                               dilations_per_block=dils, tile=128, convs_per_unit=cpu,
                               interpret=True))
    stage = _packed(stage_np, geometry)
    xt = torch.from_numpy(x)
    out = _units_composed(xt, stage)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)
    plain = mrf_block.mrf_section_plain(xt, stage.w_flat, stage.b_flat, ks, dils, cpu)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=1e-5, rtol=0)


def test_mrf_unit_plain_is_one_residual_unit():
    """ResBlock1's unit: h + conv_k(lrelu(conv_{k,d}(lrelu(h)))), 'same'
    zero padding, checked against a direct numpy evaluation."""
    rng = np.random.default_rng(7)
    c, t, k, d = 8, 40, 5, 3
    w1, w2 = (rng.standard_normal((c, c, k)).astype(np.float32) * 0.2 for _ in range(2))
    b1, b2 = (rng.standard_normal(c).astype(np.float32) * 0.1 for _ in range(2))
    h = rng.standard_normal((1, t, c)).astype(np.float32)

    def conv(x, w, b, dil):  # x [t, C_in], w [C_out, C_in, k]
        half = (k - 1) // 2
        xp = np.pad(x, ((half * dil, half * dil), (0, 0)))
        return sum(xp[j * dil : j * dil + t] @ w[:, :, j].T for j in range(k)) + b

    lrelu = lambda v: np.where(v > 0, v, 0.1 * v)  # noqa: E731
    ref = h[0] + conv(lrelu(conv(lrelu(h[0]), w1, b1, d)), w2, b2, 1)
    unit = [(torch.from_numpy(w1), torch.from_numpy(b1), d), (torch.from_numpy(w2),
                                                              torch.from_numpy(b2), 1)]
    out = mrf_block.mrf_unit_plain(torch.from_numpy(h), unit)
    np.testing.assert_allclose(out[0].numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("channels,geometry", [(8, RESBLOCK1), (32, RESBLOCK2), (64, RESBLOCK1),
                                               (128, RESBLOCK2)])
def test_pack_stages_decodes_to_the_weights(channels, geometry):
    """Every weight stage decodes back to the f32 weights: plane 0 (hi) and
    plane 1 (lo) are exact TF32 values, hi + lo = w to 2^-20 relative, and
    element (tap, kstep, ngrp, khalf, r8, k4) of a conv's stages is
    W[tap][8*kstep + 4*khalf + k4][8*ngrp + r8]."""
    ks, dils, cpu = geometry
    rng = np.random.default_rng(channels)
    stage = _packed(_random_stage(rng, channels, ks, dils, cpu), geometry)
    w_flat, wpack = stage.w_flat.numpy(), stage.wpack.numpy()
    assert wpack.size == 2 * w_flat.size
    assert np.all(wpack.view(np.int32) & 0x1FFF == 0)  # every value is a TF32 number
    c = channels
    assert wpack.size * 4 % (64 * c) == 0  # whole 64*C-byte stages
    off = 0
    for k, d in zip(ks, dils):
        for _ in range(len(d) * cpu):
            w = w_flat[off : off + k * c * c].reshape(k, c, c)  # [tap][C_in][C_out]
            v = wpack[2 * off : 2 * off + 2 * w.size].reshape(
                k, c // 8, 2, c // 8, 2, 8, 4)  # tap ks plane ngrp kh r8 k4
            decoded = (v[:, :, 0] + v[:, :, 1]).transpose(0, 1, 3, 5, 2, 4)
            # -> [tap][ks][kh][k4][ngrp][r8] = W[tap][C_in][C_out]
            np.testing.assert_allclose(decoded.reshape(k, c, c), w, rtol=2**-20, atol=0)
            off += w.size


def test_pack_stages_element_order():
    """Integer weights (exact as hi + lo) name their own source position."""
    c, k = 32, 3
    w_flat = torch.arange(k * c * c, dtype=torch.float32)
    wpack = mrf_block.pack_stages(w_flat, c, (k,), ((1,),), 1)
    v = wpack.reshape(k, c // 8, 2, c // 8, 2, 8, 4)
    for tap, ks, ngrp, kh, r8, k4 in ((0, 0, 0, 0, 0, 0), (1, 3, 3, 1, 5, 2), (2, 1, 2, 1, 7, 3)):
        hi, lo = v[tap, ks, :, ngrp, kh, r8, k4].tolist()
        c_in = 8 * ks + 4 * kh + k4
        assert hi + lo == (tap * c + c_in) * c + 8 * ngrp + r8


@pytest.mark.parametrize("k,d,cpu,stride,rows", [
    (3, 1, 2, 126, 130), (7, 3, 2, 122, 146), (11, 5, 2, 118, 178),
    (3, 2, 1, 128, 132), (7, 12, 1, 128, 200),
])
def test_unit_tile_geometry(k, d, cpu, stride, rows):
    """A block's output stride (TILE_ROWS less the second conv's k - 1) and
    the raw rows it loads (TILE_ROWS plus the first conv's halo, (k-1)/2 * d,
    on both sides)."""
    assert mrf_block.unit_stride(k, cpu) == stride
    assert mrf_block.unit_rows(k, d) == rows == mrf_block.TILE_ROWS + 2 * ((k - 1) // 2 * d)
    # every main-path and vctk_small unit fits one block at C=128
    assert mrf_block.unit_smem_bytes(128, rows) <= mrf_block.MAX_SMEM
    assert mrf_block.unit_b_stages(128, rows) >= 2
    assert rows <= mrf_block.MAX_ROWS


def test_unit_smem_bytes():
    # C=128, (11, 5): 1 KB slack + hi and lo planes of 184 rows x 512 B + 33
    # barriers, then as many 8 KB weight stages as fit in 227 KB: 5
    fixed = 1024 + 2 * 184 * 512 + 8 * 33
    assert mrf_block.unit_b_stages(128, 178) == (232448 - fixed) // 8192 == 5
    assert mrf_block.unit_smem_bytes(128, 178) == fixed + 5 * 8192
    # vctk_small's widest unit at C=128 keeps a 3-stage ring
    assert mrf_block.unit_b_stages(128, 200) == 3
    # C <= 64: two blocks per SM where 4 stages fit in half the SM
    assert mrf_block.unit_smem_bytes(64, 178) <= 115712
    assert mrf_block.unit_b_stages(64, 178) == 4
    assert mrf_block.unit_b_stages(32, 130) == 16
    assert mrf_block.unit_b_stages(128, 257) == 0  # a tile that does not fit


def test_unit_launch_plan():
    """universal_large: 9 launches a stage; each chain starts from x, walks
    the two scratch buffers and ends in out (stored by chain 0, added by the
    others, scaled by 1/3 on the last)."""
    gen = torch.Generator().manual_seed(0)
    c = 8
    conv = lambda k: {"w": torch.randn((c, c, k), generator=gen),  # noqa: E731
                      "b": torch.randn(c, generator=gen)}
    stage = mrf_block.pack_mrf_stage(
        [{"convs1": [conv(k) for _ in range(3)], "convs2": [conv(k) for _ in range(3)]}
         for k in (3, 7, 11)])
    plan = mrf_block.unit_launches(stage)
    assert len(plan) == 9
    assert [(p[6], p[7], p[8]) for p in plan[:3]] == [
        ("x", 0, mrf_block.MODE_TO_SCRATCH), (0, 1, mrf_block.MODE_TO_SCRATCH),
        (1, "out", mrf_block.MODE_OUT_STORE)]
    assert [p[8] for p in plan[3:]] == [0, 0, 2, 0, 0, 2]
    assert [p[9] for p in plan] == [1.0] * 8 + [1.0 / 3]
    # weight offsets step by a unit's two convs, hi and lo; bias rows by two
    assert [p[4] for p in plan[:4]] == [0, 2 * 2 * 3 * 64, 4 * 2 * 3 * 64, 6 * 2 * 3 * 64]
    assert plan[-1][4] + 2 * 2 * 11 * 64 == stage.wpack.numel()
    assert [p[5] for p in plan] == list(range(0, 18, 2))

    single = mrf_block.pack_mrf_stage([{"convs": [conv(3)]}], (3,), ((1,),), 1)
    assert mrf_block.unit_launches(single) == [(0, 0, 3, 1, 0, 0, "x", "out",
                                                mrf_block.MODE_OUT_STORE, 1.0)]
