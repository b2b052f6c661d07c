"""GlowTTS's flow WaveNet kernel (``larynx_tpu_torch/ops/flow_wn.py``,
``csrc/flow_wn.cu``).

On the CPU: the routing rule, the weight packing (the kernel's stage
layout, and ``pack_params``), the plain version (the kernel's arithmetic on
the packed weights) against ``flows.wavenet`` across prefix masks that end
mid-tile and leave whole tile pairs padded, the speaker bias ``g``, the
taps and the dilation, and the two counters.  Marked ``card`` (skipped
without a CUDA device): the kernel against its plain version at the main
path's shapes, and its float32 equivalence, against a float64 computation
beside the torch route with TF32 off and a single-pass TF32 route.  This
file imports no JAX; run the card cases on the chip as
``python -m pytest tests/test_torch_flow_wn.py -m card --noconftest``.
"""

import pytest
import torch

from larynx_tpu_torch.models.glow_tts import flows
from larynx_tpu_torch.models.glow_tts import model as glow_model
from larynx_tpu_torch.ops import flow_wn
from larynx_tpu_torch.ops.mrf_block import _tf32_split
from larynx_tpu_torch.runtime import trace

H = flow_wn.KERNEL_CHANNELS
# rows that end mid-tile, a row whose second tile pair is wholly padded and
# one with a single valid step
LENGTHS = (300, 140, 10, 1)
T = 300


def _torch_route(p):
    return {k: v for k, v in p.items() if k != "flow_wn"}


@pytest.mark.parametrize("device_type,dtype,requires_grad,packed,want", [
    ("cuda", torch.float32, False, True, True),
    ("cuda", torch.bfloat16, False, True, False),
    ("cuda", torch.float64, False, True, False),
    ("cpu", torch.float32, False, True, False),
    ("cuda", torch.float32, True, True, False),
    ("cuda", torch.float32, False, False, False),
])
def test_kernel_route(device_type, dtype, requires_grad, packed, want):
    """float32 CUDA inference on packed weights takes the kernel; bfloat16,
    float64, training's gradient, the CPU and unpacked weights keep torch."""
    assert flow_wn.kernel_route(device_type, dtype, requires_grad, packed) is want


def test_the_kernel_geometry():
    assert [flow_wn.packs(H, k) for k in (1, 3, 5)] == [True] * 3
    assert not any(flow_wn.packs(h, k) for h, k in ((H, 4), (H, 7), (256, 5), (96, 3)))


def test_pack_layout():
    """Each stage is one k-step of 8 rows: per consumer, the TF32 hi plane
    then the lo plane, K-major in 8-column groups; consumer c owns channels
    [96c, 96c + 96) of the gate (tanh columns, then their sigmoid partners)
    and columns [192c, 192c + 192) of the res/skip product."""
    p = flow_wn.random_stack(5, 0, layers=1)
    w = p["flow_wn"][0]
    stage = 2 * 2 * H * 8
    plane = H * 8

    def at(st, c, pl, n, k):  # stage, consumer, plane, column n of the consumer, k in the step
        return w[st * stage + (2 * c + pl) * plane + (n // 8) * 64 + (k // 4) * 32 + (n % 8) * 4
                 + k % 4]

    w_in, w_rs = p["in_w"][0], p["res_skip_w"][0]
    hi, lo = _tf32_split(w_in[:, 3, 0].contiguous())  # tap 0, input channel 3, every output
    assert at(0, 0, 0, 5, 3) == hi[5] and at(0, 0, 1, 5, 3) == lo[5]
    assert at(0, 1, 0, 5, 3) == hi[96 + 5]  # consumer 1's first tanh channel
    assert at(0, 0, 0, 96 + 5, 3) == hi[H + 5]  # consumer 0's sigmoid partner
    # tap 2, input channel 10: K row 2 * 192 + 10 = stage 49, k 2
    assert at(49, 1, 0, 96 + 7, 2) == _tf32_split(w_in[H + 96 + 7, 10, 2].reshape(1))[0][0]
    # the res/skip product after the 5 taps' 120 stages: input channel 9, skip column 4
    first = 5 * H // 8
    assert at(first + 1, 1, 0, 4, 1) == _tf32_split(w_rs[H + 4, 9].reshape(1))[0][0]
    w_a, w_rs_back = flow_wn.unpack_layer(w, 5)
    want_a = torch.cat([w_in[:, :, j].t() for j in range(5)])
    torch.testing.assert_close(w_a, want_a, rtol=2 ** -21, atol=0)
    torch.testing.assert_close(w_rs_back, w_rs.t(), rtol=2 ** -21, atol=0)


def test_pack_params():
    """The couplings' stacks are packed where the geometry fits and the
    params are float32: bfloat16 params and another width are left alone."""
    gen = torch.Generator().manual_seed(3)
    wn = {"in_w": torch.randn(2, 3, 2 * H, H, 5, generator=gen),
          "res_skip_w": torch.randn(2, 3, 2 * H, H, generator=gen)}
    params = {"encoder": {}, "decoder": {"coupling": {"wn": wn, "end_w": torch.zeros(1)}}}
    packed = glow_model.pack_params(params)
    got = packed["decoder"]["coupling"]["wn"]["flow_wn"]
    assert got.shape == (2, 3, 2 * 6 * H * 2 * H) and got.dtype == torch.float32
    assert torch.equal(got[1], flow_wn.pack_stack(wn["in_w"][1], wn["res_skip_w"][1]))
    assert "flow_wn" not in wn  # the caller's tree is left as it was
    half = {"decoder": {"coupling": {"wn": {k: v.bfloat16() for k, v in wn.items()}}}}
    assert glow_model.pack_params(half) is half
    narrow = {"decoder": {"coupling": {"wn": {"in_w": torch.zeros(2, 3, 32, 16, 5)}}}}
    assert glow_model.pack_params(narrow) is narrow


def test_kept_tiles():
    """Pairs of 64-step tiles whose mask is zero on every row are skipped."""
    _x, mask, _g = flow_wn.random_inputs(LENGTHS, T, 1)
    kept = flow_wn.kept_tiles(mask)
    assert kept[:, ::64].tolist() == [[1, 1, 1, 1, 1], [1, 1, 1, 1, 0], [1, 1, 0, 0, 0],
                                      [1, 1, 0, 0, 0]]


@pytest.mark.parametrize("taps,rate,with_g", [(5, 1, False), (5, 2, True), (3, 1, True),
                                              (1, 2, False)])
def test_plain_version_equals_wavenet(taps, rate, with_g):
    """The kernel's arithmetic on the packed weights, layer by layer, gives
    the torch route's WaveNet output, zero on every masked step."""
    p = flow_wn.random_stack(taps, 0)
    x, mask, g = flow_wn.random_inputs(LENGTHS, T, 1, with_g=with_g)
    want = flows.wavenet(_torch_route(p), x, mask, rate, g)
    got = flow_wn.wavenet_plain(p, x, mask, rate, g)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6 * float(want.abs().max()))
    assert torch.all(got[mask == 0] == 0)


def test_counters():
    """``engine.flow_wn_layers`` counts every WaveNet layer; the CPU runs the
    torch route even on packed weights; inside a tally the counts are the
    tally's alone."""
    p = flow_wn.random_stack(5, 0, layers=2)
    x, mask, _g = flow_wn.random_inputs((20, 7), 24, 1)
    before = trace.counters()
    flows.wavenet(p, x, mask)
    now = trace.counters()
    assert now.get("engine.flow_wn_layers", 0) - before.get("engine.flow_wn_layers", 0) == 2
    assert now.get("engine.flow_wn_kernel_layers", 0) == before.get(
        "engine.flow_wn_kernel_layers", 0)
    with trace.tally() as counts:
        flows.wavenet(p, x, mask)
    assert counts == {"engine.flow_wn_layers": 2} and trace.counters() == now


def test_check_stack_reads_one_launch_a_layer(monkeypatch):
    """The card check's helper, with the plain version standing in for the
    kernel (counting its launch as the kernel does): no error; a layer
    counted twice raises."""
    p = flow_wn.random_stack(3, 0, layers=2)
    x, mask, g = flow_wn.random_inputs((20, 7), 24, 1, with_g=True, layers=2)

    def stand_in(times):
        def layer(*args):
            trace.count("engine.flow_wn_kernel_layers", times)
            return flow_wn.flow_wn_layer_plain(*args)
        return layer

    monkeypatch.setattr(flow_wn, "flow_wn_layer", stand_in(1))
    assert flow_wn.check_stack(p, x, mask, g, 2) == 0.0
    monkeypatch.setattr(flow_wn, "flow_wn_layer", stand_in(2))
    with pytest.raises(AssertionError, match="2 kernel launches"):
        flow_wn.check_stack(p, x, mask, g, 2)


# -----------------------------------------------------------------------------
# On the card


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("case", flow_wn.CHECK_CASES, ids=lambda c: c[0])
def test_kernel_matches_its_plain_version(cuda, case):
    """Every layer of a 4-layer stack from the same inputs: x_out and
    skip_out within 2e-5 of the plain version's scale; one launch a layer."""
    _label, b, t, taps, rate, with_g, lengths = case
    p = flow_wn.random_stack(taps, b * t, device=cuda)
    x, mask, g = flow_wn.random_inputs(lengths, t, t, with_g=with_g, device=cuda)
    assert flow_wn.check_stack(p, x, mask, g, rate) <= flow_wn.CHECK_TOLERANCE


@pytest.mark.card
@pytest.mark.parametrize("b,t,lengths", [(8, 512, (512, 480, 400, 350, 300, 250, 200, 130)),
                                         (1, 384, (371,))])
def test_kernel_is_float32_equivalent(cuda, b, t, lengths):
    """A 4-layer stack's largest error against float64 on the valid steps:
    the kernel's at most 2x the torch route's with TF32 off, while the
    single-pass TF32 route, run beside it, is over 2x."""
    p = flow_wn.random_stack(5, 7, device=cuda)
    x, mask, g = flow_wn.random_inputs(lengths, t, 8, with_g=True, device=cuda)
    ref = flows.wavenet({k: v.double() for k, v in _torch_route(p).items()}, x.double(),
                        mask.double(), 1, g.double())
    valid = mask.bool()

    def err(out):
        return float((out.double() - ref)[valid].abs().max())

    kernel = err(flows.wavenet(p, x, mask, 1, g))
    f32 = err(flows.wavenet(_torch_route(p), x, mask, 1, g))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = err(flows.wavenet(_torch_route(p), x, mask, 1, g))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    print(f"B={b} T={t}: max error vs float64 kernel {kernel:.3e}, torch f32 {f32:.3e}, "
          f"torch TF32 {tf32:.3e}")
    assert kernel <= 2 * f32
    assert tf32 > 2 * f32
