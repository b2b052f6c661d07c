"""Tacotron2's decoder step kernel (``ops/tacotron2_step.py``,
``csrc/tacotron2_step.cu``).

On the CPU at tiny widths: the kernel module's plain version, which runs on
the packed weights in the kernel's order of stages, against
``models/tacotron2/model.py::decode_steps`` (``_prenet`` and
``_decoder_step`` a step) over 41 steps; the packing's gate interleave; the
wrapper's CPU route and the launch check's refusals; the CPU engine's
kernel-step counter.  Tolerances: 1e-10 in float64 (the two differ only in
the order of their sums) and 1e-5 in float32 (sums of at most 96 terms of
O(1) values, 41 steps fed back through the prenet).

Marked ``card`` (this file imports no JAX: ``python -m pytest
tests/test_torch_tacotron2_step.py -m card --noconftest``): the kernel
against the plain version on the card at NVIDIA's widths, a batch row
against the same row alone, a call against itself, and a CUDA engine's
counters.
"""

import numpy as np
import pytest
import torch

from larynx_tpu_torch.audio import AudioSettings
from larynx_tpu_torch.models.tacotron2 import Tacotron2Config
from larynx_tpu_torch.models.tacotron2 import model as tm
from larynx_tpu_torch.ops import tacotron2_step as ts
from larynx_tpu_torch.runtime import trace
from larynx_tpu_torch.runtime.engine import SynthesisEngine
from larynx_tpu_torch.weights import cast, init_params, params_from_jax, tree_to

TINY = dict(num_symbols=40, symbols_embedding_dim=32, encoder_embedding_dim=32,
            encoder_n_convolutions=2, prenet_dim=16, attention_rnn_dim=48, decoder_rnn_dim=40,
            attention_dim=24, attention_location_n_filters=8, attention_location_kernel_size=15,
            postnet_embedding_dim=32, postnet_n_convolutions=2, max_decoder_steps=40)
STEPS = 41
TOL = {torch.float64: 1e-10, torch.float32: 1e-5}


def _params(cfg, seed=0, device="cpu", dtype=torch.float32):
    tree = init_params(torch.Generator().manual_seed(seed), cfg)
    return cast(tree_to(params_from_jax(tree, "tacotron2"), device), dtype)


def _problem(cfg, params, b, t, seed=1, keep=True, steps=STEPS, random_state=False):
    """Memory, processed memory and mask of b rows at text length t (row 1
    shorter, the last of 3 or more a padding row: mask all 0, no masks
    drawn), a start state and frame, and keep masks or None."""
    gen = torch.Generator().manual_seed(seed)
    dtype, device = params["embedding"].dtype, params["embedding"].device
    lengths = torch.full((b,), t, dtype=torch.int32)
    if b > 1:
        lengths[1] = max(1, t - 5)
    if b > 2:
        lengths[-1] = 0
    ids = torch.randint(1, cfg.num_symbols, (b, t), generator=gen)
    memory, mask = tm.encode(params, cfg, ids.to(device), lengths.to(device))
    mask = mask.to(dtype)
    processed = torch.nn.functional.linear(memory, params["decoder"]["attention"]["memory"]["w"])
    state = tm._decoder_state0(cfg, b, t, memory)
    prev = memory.new_zeros((b, cfg.mel_channels))
    if random_state:
        for name, value in state.items():
            x = torch.randn(value.shape, generator=gen, dtype=torch.float64)
            x = x.abs() * 0.05 if name.startswith("attn_w") else x * 0.5
            state[name] = x.to(device=device, dtype=dtype)
        prev = (torch.randn(prev.shape, generator=gen, dtype=torch.float64) * 0.5).to(prev)
    masks = None
    if keep:
        entropies = [None if (b > 2 and r == b - 1) else [seed, r] for r in range(b)]
        masks = tm.row_keep_masks(cfg, steps, entropies).to(device)
    return state, prev, memory, processed, mask, masks


def _max_err(a, b):
    (sa, pa, ma, ga), (sb, pb, mb, gb) = a, b
    errs = [(ma - mb).abs().max(), (ga - gb).abs().max(), (pa - pb).abs().max()]
    errs += [(sa[k] - sb[k]).abs().max() for k in ts.STATE_KEYS]
    return float(max(errs))


# ----------------------------------------------------------------------
# the plain version on the packed weights


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_the_plain_version_equals_decode_steps(b, dtype):
    """41 steps at two text lengths, keep masks on and off; with 3 or more
    rows a shorter row and a padding row."""
    cfg = Tacotron2Config(**TINY)
    params = _params(cfg, dtype=dtype)
    packed = ts.pack_decoder(params["decoder"], cfg.p_prenet_dropout)
    for t in (7, 13):
        for keep in (True, False):
            state, prev, memory, processed, mask, masks = _problem(cfg, params, b, t, keep=keep)
            want = tm.decode_steps(params, cfg, state, prev, memory, processed, mask, STEPS,
                                   masks)
            got = ts.decode_steps_plain(packed, state, prev, memory, processed, mask, STEPS,
                                        masks)
            assert got[2].shape == (b, STEPS, cfg.mel_channels) and got[3].shape == (b, STEPS)
            assert _max_err(got, want) <= TOL[dtype], (t, keep)
            if keep:  # the masks reach the decode
                free = ts.decode_steps_plain(packed, state, prev, memory, processed, mask,
                                             STEPS, None)
                assert _max_err(free, want) > 1e-3


def test_the_gate_interleave_round_trips():
    w = torch.randn(4 * 6, 5, generator=torch.Generator().manual_seed(3))
    inter = ts.interleave_gates(w)
    for j in range(6):
        for r in range(4):
            assert torch.equal(inter[4 * j + r], w[r * 6 + j])
    assert torch.equal(ts.deinterleave_gates(inter), w)
    b = torch.arange(8.0)
    assert torch.equal(ts.deinterleave_gates(ts.interleave_gates(b)), b)


def test_pack_decoder_layout():
    cfg = Tacotron2Config(**TINY)
    dec = _params(cfg)["decoder"]
    packed = ts.pack_decoder(dec, cfg.p_prenet_dropout)
    att, rnn = dec["attention_rnn"], dec["decoder_rnn"]
    assert torch.equal(ts.deinterleave_gates(packed.att_w),
                       torch.cat([att["w_ih"], att["w_hh"]], dim=1))
    assert torch.equal(ts.deinterleave_gates(packed.dec_w),
                       torch.cat([rnn["w_ih"], rnn["w_hh"]], dim=1))
    assert torch.equal(ts.deinterleave_gates(packed.dec_b), rnn["b"])
    m = cfg.mel_channels
    assert packed.proj_w.shape[0] % 4 == 0 and packed.proj_w.shape[0] >= m + 1
    assert torch.equal(packed.proj_w[:m], dec["projection"]["w"])
    assert torch.equal(packed.proj_w[m], dec["gate"]["w"][0])
    assert not packed.proj_w[m + 1:].any() and not packed.proj_b[m + 1:].any()
    assert all(x.is_contiguous() for x in packed.tensors())


def test_pack_params_leaves_cpu_params_as_they_are():
    cfg = Tacotron2Config(**TINY)
    params = _params(cfg)
    assert tm.pack_params(params, cfg) is params


# ----------------------------------------------------------------------
# the wrapper


def test_the_wrapper_runs_the_plain_version_for_cpu_tensors():
    """The wrapper takes CUDA tensors only: a CPU tensor raises and launches
    nothing.  The plain version is the kernel's reference, not a CPU route:
    the model's own step loop runs on the CPU."""
    cfg = Tacotron2Config(**TINY)
    params = _params(cfg)
    packed = ts.pack_decoder(params["decoder"], cfg.p_prenet_dropout)
    problem = _problem(cfg, params, 3, 9, keep=True, steps=5, random_state=True)
    launches = ts.decode_steps.launches
    with pytest.raises(ValueError, match="runs on cuda tensors, got cpu"):
        ts.decode_steps(packed, *problem[:5], 5, problem[5])
    assert ts.decode_steps.launches == launches


def _refused(case):
    """The launch check's arguments at kernel-able tiny widths, with one
    thing the kernel does not take, and the error it raises."""
    cfg = Tacotron2Config(**TINY)
    params = _params(cfg)
    packed = ts.pack_decoder(params["decoder"], cfg.p_prenet_dropout)
    state, prev, memory, processed, mask, keep = _problem(cfg, params, 3, 9, steps=4)
    n = 4
    if case == "float64":
        memory, err = memory.double(), TypeError
    elif case == "bool mask":
        mask, err = mask > 0, TypeError
    elif case == "strided memory":
        memory, err = memory.transpose(0, 1).contiguous().transpose(0, 1), ValueError
    elif case == "strided state":
        state, err = dict(state, attn_h=state["attn_h"].t().contiguous().t()), ValueError
    elif case == "width":
        odd = Tacotron2Config(**dict(TINY, attention_dim=22))
        packed, err = ts.pack_decoder(_params(odd)["decoder"], odd.p_prenet_dropout), \
            NotImplementedError
        processed = processed[..., :22].contiguous()
    elif case == "even kernel":
        even = Tacotron2Config(**dict(TINY, attention_location_kernel_size=14))
        packed, err = ts.pack_decoder(_params(even)["decoder"], even.p_prenet_dropout), \
            NotImplementedError
    elif case == "mask length":
        mask, err = mask[:, :5].contiguous(), ValueError
    elif case == "keep dtype":
        keep, err = keep.float(), ValueError
    elif case == "keep steps":
        keep, err = keep[:3], ValueError
    elif case == "no steps":
        n, keep, err = 0, None, ValueError
    elif case == "state keys":
        state = {k: v for k, v in state.items() if k != "context"}
        err = ValueError
    elif case == "two devices":
        prev, err = torch.empty(prev.shape, device="meta"), ValueError
    elif case == "prev rows":
        prev, err = torch.zeros(prev.shape[1], prev.shape[0]).t(), ValueError
    else:
        raise AssertionError(case)
    return (packed, state, prev, memory, processed, mask, n, keep), err


REFUSED = ["float64", "bool mask", "strided memory", "strided state", "width", "even kernel",
           "mask length", "keep dtype", "keep steps", "no steps", "state keys", "two devices",
           "prev rows"]


@pytest.mark.parametrize("case", REFUSED)
def test_the_launch_check_refuses(case):
    args, err = _refused(case)
    with pytest.raises(err):
        ts.check_launch(*args)


def test_the_launch_check_takes_what_the_kernel_takes():
    """A batch's arguments, the last frame a row view of the mels."""
    cfg = Tacotron2Config(**TINY)
    params = _params(cfg)
    packed = ts.pack_decoder(params["decoder"], cfg.p_prenet_dropout)
    state, prev, memory, processed, mask, keep = _problem(cfg, params, 3, 9, steps=4)
    mels = torch.zeros(3, 4, cfg.mel_channels)
    ts.check_launch(packed, state, mels[:, -1], memory, processed, mask, 4, keep)


def test_a_cpu_engine_runs_no_kernel_steps():
    cfg = Tacotron2Config(**TINY)
    tree = init_params(torch.Generator().manual_seed(0), cfg)
    tree["decoder"]["gate"]["b"][:] = -50.0
    eng = SynthesisEngine(params_from_jax(tree, "tacotron2"), cfg, AudioSettings(),
                          vocoder_kind="none", device="cpu")
    before = dict(trace.counters())
    ids = [np.arange(1, 8, dtype=np.int64), np.arange(2, 6, dtype=np.int64)]
    eng.encode_launch(ids, max_decoder_steps=12)
    after = dict(trace.counters())
    assert after.get("engine.ar_steps", 0) - before.get("engine.ar_steps", 0) == 12
    assert after.get("engine.ar_kernel_steps", 0) == before.get("engine.ar_kernel_steps", 0)
    assert "step_kernel" not in eng.glow_params["decoder"]


# ----------------------------------------------------------------------
# on the card

# The kernel against the plain version (cuBLAS in float32, TF32 off) at
# NVIDIA's widths: the two sum up to 2560 float32 products in other orders
# (~1e-6 of a gate's magnitude), and each step feeds the next through the
# prenet and the states; a gate order, mask, layout or stage fault moves
# the outputs by O(1e-2) or more.  Measured on an H100: at most 8.1e-7 (PERF.md).
CARD_TOL = 2e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step kernel runs only there")
    prior = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prior


def _card_problem(b, t, seed=0, keep=True, steps=32):
    cfg = Tacotron2Config()
    params = tm.pack_params(_params(cfg, seed=seed, device="cuda"), cfg)
    return cfg, params, _problem(cfg, params, b, t, seed=seed + 1, keep=keep, steps=steps,
                                 random_state=True)


def _rel_err(a, b):
    (sa, pa, ma, ga), (sb, pb, mb, gb) = a, b
    pairs = [(ma, mb), (ga, gb), (pa, pb)] + [(sa[k], sb[k]) for k in ts.STATE_KEYS]
    return max(float((x - y).abs().max()) / max(1.0, float(y.abs().max())) for x, y in pairs)


@pytest.mark.card
@pytest.mark.parametrize("t", [32, 96, 384, 500])
@pytest.mark.parametrize("b", [1, 8, 16])
def test_the_kernel_equals_the_plain_version(card, b, t):
    """n in {1, 7, 16, 32}, masks on and off; T 500 is past the largest text
    bucket (384); B=16 runs as two launches of 8 rows."""
    with torch.inference_mode():
        for keep in (True, False):
            cfg, params, problem = _card_problem(b, t, keep=keep)
            packed = params["decoder"]["step_kernel"]
            for n in (1, 7, 16, 32):
                masks = None if problem[5] is None else problem[5][:n]
                launches = ts.decode_steps.launches
                got = ts.decode_steps(packed, *problem[:5], n, masks)
                want = ts.decode_steps_plain(packed, *problem[:5], n, masks)
                torch.cuda.synchronize()
                assert ts.decode_steps.launches == launches + -(-b // ts.MAX_ROWS)
                assert _rel_err(got, want) <= CARD_TOL, (keep, n)


@pytest.mark.card
def test_a_batch_row_equals_the_row_alone_and_a_call_repeats(card):
    with torch.inference_mode():
        cfg, params, problem = _card_problem(8, 96)
        packed = params["decoder"]["step_kernel"]
        state, prev, memory, processed, mask, keep = problem
        batch = ts.decode_steps(packed, *problem[:5], 32, keep)
        again = ts.decode_steps(packed, *problem[:5], 32, keep)
        assert all(torch.equal(x, y) for x, y in zip(batch[1:], again[1:]))
        assert all(torch.equal(batch[0][k], again[0][k]) for k in ts.STATE_KEYS)
        for r in (0, 1, 5, 7):
            rows = slice(r, r + 1)
            alone = ts.decode_steps(packed, {k: v[rows].contiguous() for k, v in state.items()},
                                    prev[rows].contiguous(), memory[rows].contiguous(),
                                    processed[rows].contiguous(), mask[rows].contiguous(), 32,
                                    keep[:, :, rows].contiguous())
            assert torch.equal(alone[2], batch[2][rows]) and torch.equal(alone[3], batch[3][rows])
            assert all(torch.equal(alone[0][k], batch[0][k][rows]) for k in ts.STATE_KEYS)


@pytest.mark.card
def test_a_cuda_engine_runs_every_step_in_the_kernel(card):
    cfg = Tacotron2Config()
    tree = init_params(torch.Generator().manual_seed(0), cfg)
    tree["decoder"]["gate"]["b"][:] = -50.0
    eng = SynthesisEngine(params_from_jax(tree, "tacotron2"), cfg, AudioSettings(),
                          vocoder_kind="none", device="cuda")
    rng = np.random.default_rng(0)
    ids = [rng.integers(1, 148, size=n).astype(np.int64) for n in (40, 25, 60)]
    before = dict(trace.counters())
    for caps in (70, [40, 90, 20]):
        eng.encode_launch(ids, max_decoder_steps=caps)
    after = dict(trace.counters())
    steps = after["engine.ar_steps"] - before.get("engine.ar_steps", 0)
    assert steps == 70 + 90
    assert after["engine.ar_kernel_steps"] - before.get("engine.ar_kernel_steps", 0) == steps
