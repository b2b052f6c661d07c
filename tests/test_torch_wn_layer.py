"""The port's WN layer (plain versions behind the wrappers) against the JAX package.

The plain versions, reached through ``fused_wn_layer_state`` and
``fused_wn_layer`` on CPU tensors, are held against the JAX Pallas kernels
run in interpret mode (as ``tests/test_pallas_ops.py`` runs them on the
CPU), on the same numpy inputs: single layers at dilation 1, 4 and 128 in
every mode, a three-layer stack at the WaveGlow wn_256 width (ch 256,
cc 640), and a narrow geometry.  T is never a multiple of the Pallas tile.

Tolerance: 2e-5 absolute, float32, the bound ``test_pallas_ops`` uses for
the state kernel against XLA.  A layer's pre-gate sum runs over 3*ch + cc
products (1408 at wn_256) of weights ~0.05 and O(1) inputs, summed in
other orders: ~1e-6 observed.

Also here: the kernel's weight stages (TF32 hi/lo planes in wgmma operand
order, built on the CPU at load) and the wrappers' guards: the plain
version only for CPU tensors, and no fallback when the CUDA library cannot
be had.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larynx_tpu.ops.wn_layer import fused_wn_layer as j_wn_layer
from larynx_tpu.ops.wn_layer import fused_wn_layer_state as j_wn_layer_state
from larynx_tpu_torch.ops import wn_layer

ATOL = 2e-5


def _layer_np(rng, ch, cc, rs_out):
    """One layer in the JAX layout: w_in [3, ch, 2ch], w_cond [cc, 2ch], w_rs [ch, rs_out]."""
    n = lambda shape, s: (rng.standard_normal(shape) * s).astype(np.float32)  # noqa: E731
    return dict(
        w_in=n((3, ch, 2 * ch), 0.05), b_in=n((2 * ch,), 0.01),
        w_cond=n((cc, 2 * ch), 0.05), b_cond=n((2 * ch,), 0.01),
        w_rs=n((ch, rs_out), 0.05), b_rs=n((rs_out,), 0.01),
    )


def _pack(layer_np) -> wn_layer.WNLayer:
    """The JAX-layout numpy layer -> the port's packed layer (torch layout)."""
    t = {k: torch.from_numpy(v) for k, v in layer_np.items()}
    return wn_layer.pack_wn_layer(
        t["w_in"].permute(2, 1, 0).contiguous(), t["b_in"], t["w_cond"].t().contiguous(),
        t["b_cond"], t["w_rs"].t().contiguous(), t["b_rs"],
    )


def _jax_args(layer_np):
    return [jnp.asarray(layer_np[k]) for k in ("w_in", "b_in", "w_cond", "b_cond", "w_rs", "b_rs")]


@pytest.mark.parametrize("dilation", [1, 4, 128])
@pytest.mark.parametrize("position", ["first", "mid", "last", "first_last"])
def test_wn_layer_state_matches_pallas(dilation, position):
    """One layer with its state update, at wn_256 width, T = 300.

    The port's plain function runs in float64 on the same inputs and
    weights, so the comparison measures the Pallas side's float32 error
    (~1.2e-6) and the two functions' agreement, not the float32 rounding of
    torch's CPU ops in whatever state earlier tests left the process: under
    the xdist run this case's float32 port side intermittently sat 25x
    further from float64 than usual, for a cause not found.  The float32 path
    through the wrapper is held to the same tolerance by the rs and stack
    cases below."""
    first, last = position.startswith("first"), position.endswith("last")
    ch, cc, b, t = 256, 640, 2, 300
    rng = np.random.default_rng(dilation)
    layer = _layer_np(rng, ch, cc, ch if last else 2 * ch)
    h = rng.standard_normal((b, t, ch)).astype(np.float32)
    cond = rng.standard_normal((b, t, cc)).astype(np.float32)
    skip = None if first else rng.standard_normal((b, t, ch)).astype(np.float32)

    ref_h, ref_s = j_wn_layer_state(
        jnp.asarray(h), jnp.asarray(cond), None if first else jnp.asarray(skip),
        *_jax_args(layer), dilation=dilation, first=first, last=last, tile=128, interpret=True,
    )
    f64 = lambda a: None if a is None else torch.from_numpy(a).double()  # noqa: E731
    packed = _pack(layer)
    out_h, out_s = wn_layer.wn_layer_state_plain(
        f64(h), f64(cond), f64(skip), packed.w_in.double(), packed.w_cond.double(),
        packed.bias_a.double(), packed.w_rs.double(), packed.b_rs.double(), dilation, first, last,
    )
    np.testing.assert_allclose(out_h.numpy(), np.asarray(ref_h), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out_s.numpy(), np.asarray(ref_s), atol=ATOL, rtol=0)


@pytest.mark.parametrize("rs_out", [512, 256])
@pytest.mark.parametrize("dilation", [1, 4, 128])
def test_wn_layer_matches_pallas(dilation, rs_out):
    """The layer alone (rs), at wn_256 width, T = 200."""
    ch, cc, b, t = 256, 640, 2, 200
    rng = np.random.default_rng(10 + dilation)
    layer = _layer_np(rng, ch, cc, rs_out)
    h = rng.standard_normal((b, t, ch)).astype(np.float32)
    cond = rng.standard_normal((b, t, cc)).astype(np.float32)
    ref = j_wn_layer(jnp.asarray(h), jnp.asarray(cond), *_jax_args(layer), dilation=dilation,
                     tile=128, interpret=True)
    out = wn_layer.fused_wn_layer(torch.from_numpy(h), torch.from_numpy(cond), _pack(layer),
                                  dilation=dilation)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("ch,cc,t", [(256, 640, 150), (32, 64, 77)], ids=["wn_256", "narrow"])
def test_wn_stack_matches_pallas(ch, cc, t):
    """A three-layer stack (first, middle, last; dilations 1, 2, 4): the
    state walks through the port's layers as through the Pallas kernels."""
    rng = np.random.default_rng(ch)
    layers = [_layer_np(rng, ch, cc, ch if i == 2 else 2 * ch) for i in range(3)]
    h0 = rng.standard_normal((2, t, ch)).astype(np.float32)
    cond = rng.standard_normal((2, t, cc)).astype(np.float32)

    jh, js = jnp.asarray(h0), None
    th, ts = torch.from_numpy(h0), None
    for i, layer in enumerate(layers):
        flags = dict(dilation=2**i, first=i == 0, last=i == 2)
        jh, js = j_wn_layer_state(jh, jnp.asarray(cond), js, *_jax_args(layer), **flags,
                                  tile=64, interpret=True)
        th, ts = wn_layer.fused_wn_layer_state(th, torch.from_numpy(cond), ts, _pack(layer),
                                               **flags)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL, rtol=0)


@pytest.mark.parametrize("rs_out", [512, 256])
def test_pack_weights_layout(rs_out):
    """The documented stage order (``_stages``), element by element, for a
    first product of K = 64 and the second product at rs_out 512 and 256.
    Integer weights below 2^22 are hi + lo exactly, so every element's
    source position can be read back from the two planes."""
    ch, k = 256, 64
    w_a = torch.arange(k * 2 * ch, dtype=torch.float32).reshape(k, 2 * ch)
    w_rs = torch.arange(ch * rs_out, dtype=torch.float32).reshape(ch, rs_out) + 0.5
    packed = wn_layer.pack_weights(w_a, w_rs)
    assert packed.numel() == 2 * (k * 2 * ch + ch * rs_out)
    assert packed.numel() * 4 % wn_layer.STAGE_BYTES == 0

    def check(flat, w, cols_of):
        n = w.shape[1] // wn_layer.CONSUMERS
        kps = wn_layer.STAGE_BYTES // (wn_layer.CONSUMERS * 2 * n * 8 * 4)
        v = flat.reshape(-1, kps, wn_layer.CONSUMERS, 2, n // 8, 2, 8, 4)
        for stage in (0, v.shape[0] - 1):
            for j in range(kps):
                for c in range(wn_layer.CONSUMERS):
                    for ngrp in (0, 5, n // 8 - 1):
                        for kgrp, r8, k4 in ((0, 0, 0), (1, 3, 2), (1, 7, 3)):
                            row = 8 * (stage * kps + j) + 4 * kgrp + k4
                            col = cols_of(c, 8 * ngrp + r8)
                            hi, lo = v[stage, j, c, :, ngrp, kgrp, r8, k4].tolist()
                            assert hi + lo == w[row, col].item(), (stage, j, c, ngrp, kgrp, r8, k4)

    half = ch // wn_layer.CONSUMERS
    n_a = w_a.numel() * 2
    # first product: consumer c's tanh columns, then their sigmoid partners
    check(packed[:n_a], w_a,
          lambda c, i: c * half + i if i < half else ch + c * half + (i - half))
    # second product: consumer c owns a contiguous half of rs
    check(packed[n_a:], w_rs, lambda c, i: c * (rs_out // 2) + i)


@pytest.mark.parametrize("scale", [1e-3, 0.05, 1.0, 300.0])
def test_pack_weights_tf32_planes(scale):
    """Realistic weights: hi and lo are exact TF32 values (low 13 mantissa
    bits zero) and hi + lo gives each w to 2^-21 relative.  Packing the
    element indices (integers < 2^22, exact as hi + lo) tells which weight
    each packed pair holds."""
    rng = np.random.default_rng(int(scale * 1000))
    layer = _pack(_layer_np(rng, 256, 640, 512))
    w_a = torch.cat([layer.w_in[:, :, tap].t() for tap in range(3)] + [layer.w_cond.t()]) * scale
    w_rs = layer.w_rs.t() * scale
    planes = wn_layer.pack_weights(w_a, w_rs).reshape(-1, 2, 2048)  # [block][hi, lo][8 KB]
    assert (planes.view(torch.int32) & 0x1FFF).eq(0).all()

    n_a = w_a.numel()
    index = wn_layer.pack_weights(
        torch.arange(n_a, dtype=torch.float32).reshape(w_a.shape),
        torch.arange(n_a, n_a + w_rs.numel(), dtype=torch.float32).reshape(w_rs.shape),
    ).reshape(-1, 2, 2048)
    index = (index[:, 0] + index[:, 1]).long()
    assert torch.equal(torch.sort(index.reshape(-1)).values, torch.arange(n_a + w_rs.numel()))
    w = torch.cat([w_a.reshape(-1), w_rs.reshape(-1)]).double()[index]
    got = planes[:, 0].double() + planes[:, 1].double()
    rel = ((got - w).abs() / w.abs().clamp_min(1e-30)).max().item()
    assert rel <= 2.0**-21


def test_pack_wn_layer_geometry():
    rng = np.random.default_rng(0)
    wide = _pack(_layer_np(rng, 256, 640, 512))
    # TF32 hi and lo planes of [W0; W1; W2; Wc] and of Wrs, in 32 KB stages
    assert wide.wpack.numel() == 2 * ((3 * 256 + 640) * 512 + 256 * 512)
    assert wide.wpack.numel() * 4 == 208 * wn_layer.STAGE_BYTES
    last = _pack(_layer_np(rng, 256, 640, 256))
    assert last.wpack.numel() * 4 == 192 * wn_layer.STAGE_BYTES
    narrow = _pack(_layer_np(rng, 32, 64, 64))
    assert narrow.wpack is None  # the kernel takes ch=256 only
    assert not wn_layer.kernel_takes(256, 100) and wn_layer.kernel_takes(256, 64)


def _inputs(ch=256, cc=640, t=40, rs_out=512):
    rng = np.random.default_rng(5)
    layer = _pack(_layer_np(rng, ch, cc, rs_out))
    h = torch.from_numpy(rng.standard_normal((1, t, ch)).astype(np.float32))
    cond = torch.from_numpy(rng.standard_normal((1, t, cc)).astype(np.float32))
    return layer, h, cond


def test_wn_wrappers_run_plain_only_on_cpu(monkeypatch):
    layer, h, cond = _inputs()
    before = (wn_layer.fused_wn_layer_state.launches, wn_layer.fused_wn_layer.launches)
    out = wn_layer.fused_wn_layer(h, cond, layer, dilation=2)
    ref = wn_layer.wn_layer_plain(h, cond, layer.w_in, layer.w_cond, layer.bias_a, layer.w_rs,
                                  layer.b_rs, 2)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    h_new, skip = wn_layer.fused_wn_layer_state(h, cond, None, layer, dilation=2, first=True)
    ref_h, ref_s = wn_layer.wn_layer_state_plain(h, cond, None, layer.w_in, layer.w_cond,
                                                 layer.bias_a, layer.w_rs, layer.b_rs, 2, True)
    torch.testing.assert_close(h_new, ref_h, rtol=0, atol=0)
    torch.testing.assert_close(skip, ref_s, rtol=0, atol=0)
    # the CPU path launches nothing
    assert (wn_layer.fused_wn_layer_state.launches, wn_layer.fused_wn_layer.launches) == before

    def no_plain(*args, **kwargs):
        raise AssertionError("plain version taken for a non-CPU tensor")

    monkeypatch.setattr(wn_layer, "wn_layer_plain", no_plain)
    monkeypatch.setattr(wn_layer, "wn_layer_state_plain", no_plain)
    with pytest.raises(ValueError, match="cpu or cuda"):
        wn_layer.fused_wn_layer(h.to("meta"), cond.to("meta"), layer, dilation=1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        wn_layer.fused_wn_layer_state(h.to("meta"), cond.to("meta"), None, layer, dilation=1,
                                      first=True)


def test_wn_wrappers_launch_or_raise_for_cuda(monkeypatch):
    """A CUDA tensor goes to the kernel: when the kernel cannot be had, both
    wrappers raise instead of falling back to the plain version."""
    layer, _h, _cond = _inputs()

    class CudaLike:
        device = torch.device("cuda", 0)
        dtype = torch.float32
        shape = (1, 40, 256)

    def no_plain(*args, **kwargs):
        raise AssertionError("plain version taken for a CUDA tensor")

    def no_library(*args):  # the float32 or the bfloat16 kernel's library
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(wn_layer, "wn_layer_plain", no_plain)
    monkeypatch.setattr(wn_layer, "wn_layer_state_plain", no_plain)
    monkeypatch.setattr(wn_layer, "_check", lambda *args: None)
    monkeypatch.setattr(wn_layer, "_library", no_library)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        wn_layer.fused_wn_layer(CudaLike(), CudaLike(), layer, dilation=1)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        wn_layer.fused_wn_layer_state(CudaLike(), CudaLike(), None, layer, dilation=1, first=True)


def test_wn_wrappers_reject_what_the_kernel_does_not_take():
    layer, h, cond = _inputs()
    wn_layer._check(h, cond, None, layer, 512, 1)
    with pytest.raises(TypeError):
        wn_layer._check(h.double(), cond, None, layer, 512, 1)
    with pytest.raises(NotImplementedError):
        wn_layer._check(torch.zeros((1, 40, 128)), cond, None, layer, 512, 1)
    with pytest.raises(NotImplementedError):
        wn_layer._check(h, torch.zeros((1, 40, 100)), None, layer, 512, 1)
    with pytest.raises(ValueError, match="contiguous"):
        wn_layer._check(torch.zeros((1, 256, 40)).transpose(1, 2), cond, None, layer, 512, 1)
    with pytest.raises(ValueError, match="skip"):
        wn_layer._check(h, cond, torch.zeros((1, 39, 256)), layer, 512, 1)
    with pytest.raises(ValueError, match="packed weights"):
        wn_layer._check(h, cond, None, layer, 256, 1)
    with pytest.raises(ValueError, match="last"):
        wn_layer.fused_wn_layer_state(h, cond, h, layer, dilation=1, last=True)
    with pytest.raises(ValueError, match="skip is required"):
        wn_layer.fused_wn_layer_state(h, cond, None, layer, dilation=1)
