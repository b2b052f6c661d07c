"""Tacotron2, as in ``larynx_tpu/models/tacotron2/model.py``: inference and
the teacher-forced training forward.

Plain functions on the port's parameter tree (``weights.params_from_jax``):
linears and LSTM gates ``[out, in]``, convs ``[C_out, C_in, k]``; the
activations keep the JAX package's channels-last layout.  The JAX package
leaves every product here to XLA (no Pallas kernel), so the port runs them
as PyTorch ops, but for the decoder's steps on a CUDA device: those run in
one hand-written kernel a call (``ops/tacotron2_step.py``), on weights that
:func:`pack_params` packs once per loaded voice.

  ``encode``            ids [B, T] -> (memory [B, T, E], mask [B, T]):
                        embedding, conv + BatchNorm + ReLU layers, a BiLSTM
                        whose padded steps carry the state unchanged.
  ``pack_params``       the params with the step kernel's packed weights
                        (``decoder["step_kernel"]``) on a CUDA device.
  ``decode_steps``      a block of decoder steps: the step kernel on CUDA,
                        ``_prenet`` and ``_decoder_step`` per step on the
                        CPU (training's ``decode_teacher`` runs those too).
  ``decode_blocked``    the autoregressive steps (prenet, attention LSTM,
                        location-sensitive attention, decoder LSTM,
                        projection and gate) over a batch whose rows each
                        have a step cap, ended early: the host reads the
                        rows' stops once per block of steps, and the decode
                        ends at the first block boundary where every row has
                        stopped and its postnet halo is decoded.
  ``infer``             ``encode``, ``decode_blocked`` at one cap for every
                        row, and the postnet.
  ``postnet``           the 5-conv residual refiner.
  ``forward_teacher``   training: ``encode`` and ``postnet`` in train mode
                        (BatchNorm over the batch, encoder dropout) around
                        ``decode_teacher``, the decoder fed the right-shifted
                        targets.

The NVIDIA quirk of prenet dropout at inference is kept.  The JAX package
draws its masks per step from ``fold_in`` keys, whose bits torch cannot
reproduce; the port takes the whole decode's keep masks as one tensor
(:func:`draw_keep_masks`, or injected by a caller), so the decode has no
per-step random launch and the CUDA and CPU runs use the same masks.  Each
row's masks are drawn on the CPU from a generator of its own
(:func:`row_keep_masks`), so they depend neither on the row's batchmates
nor on how many steps are drawn.
Training's dropout masks (encoder and prenet) enter the same way, drawn per
step by ``models/tacotron2/training.py::draw_train_masks``.  Train mode
only applies the two dropouts the JAX package applies: the config's
attention and decoder dropout rates are declared there and never used.
"""

import collections
import concurrent.futures
import threading
import typing

import numpy as np
import torch
import torch.nn.functional as F

from larynx_tpu_torch.device import to_device
from larynx_tpu_torch.models.nn import conv1d, sequence_mask
from larynx_tpu_torch.models.tacotron2.config import Tacotron2Config
from larynx_tpu_torch.ops import tacotron2_step

Params = typing.Dict[str, typing.Any]

_MASK_VALUE = -1e9

# decoder steps between two host reads of the rows' stops (decode_blocked):
# on CUDA the next block is launched before a block's stops are read, so the
# host's work between blocks (the keep masks' draw, the launch, the read)
# has to fit in a block's device time; the decode's end overshoots the last
# stop plus the postnet halo by half a block on average
STOP_CHECK_STEPS = 32
# threads that draw the rows' keep masks of a block (RowKeepMasks): the
# CPU generators' draws, ~0.2 ms a row a block at NVIDIA's widths, release
# the GIL and run side by side
KEEP_DRAW_THREADS = 4


# -----------------------------------------------------------------------------
# Primitives


def _gates_to_state(gates: torch.Tensor, c: torch.Tensor):
    """Gate pre-activations [B, 4H] (torch order i, f, g, o) -> (h, c)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def lstm_cell(p: Params, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """Fused LSTM cell: ``w_ih`` [4H, in], ``w_hh`` [4H, H], one bias ``b``."""
    return _gates_to_state(F.linear(x, p["w_ih"], p["b"]) + F.linear(h, p["w_hh"]), c)


def _lstm_scan(
    p: Params,
    x: torch.Tensor,
    reverse: bool = False,
    mask: typing.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """An LSTM over time: x [B, T, C] -> h sequence [B, T, H].

    The input projection is one product over all T.  With ``mask`` [B, T]
    a padded step leaves h and c as they were, so the reverse direction
    starts at each row's last valid frame (torch's packed sequences)."""
    bsz, t, _ = x.shape
    hidden = p["w_hh"].shape[1]
    xw = F.linear(x, p["w_ih"], p["b"])  # [B, T, 4H]
    h = x.new_zeros((bsz, hidden))
    c = x.new_zeros((bsz, hidden))
    keep = None if mask is None else (mask > 0)[..., None]  # [B, T, 1]
    hs = []
    for step in (range(t - 1, -1, -1) if reverse else range(t)):
        h_new, c_new = _gates_to_state(xw[:, step] + F.linear(h, p["w_hh"]), c)
        if keep is None:
            h, c = h_new, c_new
        else:
            h = torch.where(keep[:, step], h_new, h)
            c = torch.where(keep[:, step], c_new, c)
        hs.append(h)
    if reverse:
        hs.reverse()
    return torch.stack(hs, dim=1)


def _bn(p: Params, x: torch.Tensor, train: bool = False, eps: float = 1e-5, reduce=None):
    """BatchNorm over the channel axis: with the running statistics, or in
    ``train`` mode with the batch's mean and biased variance over (B, T),
    padded positions included, as JAX.  Returns (y, (mean, var) in train
    mode, else None).  With ``reduce`` (the data group's differentiable
    sum) the statistics are the global batch's, in two passes (the sum and
    the count, then the squared deviations' sum)."""
    if not train:
        mean, var = p["mean"], p["var"]
    elif reduce is None:
        var, mean = torch.var_mean(x, dim=(0, 1), correction=0)
    else:
        c = x.shape[-1]
        count = torch.full((1,), float(x.shape[0] * x.shape[1]), device=x.device, dtype=x.dtype)
        sums = reduce(torch.cat([x.sum(dim=(0, 1)), count]))
        mean = sums[:c] / sums[c]
        var = reduce((x - mean).square().sum(dim=(0, 1))) / sums[c]
    y = (x - mean) * torch.rsqrt(var + eps) * p["gamma"] + p["beta"]
    return y, ((mean, var) if train else None)


def _collect(bn_stats: typing.Optional[list], p: Params, stats, y: torch.Tensor,
             reduce=None) -> None:
    """Append a train-mode BatchNorm's (params, mean, var, n) to
    ``bn_stats``, n = B * T of its output ``y``: the values per channel (a
    tensor, the global batch's, with ``reduce``)."""
    if bn_stats is not None and stats is not None:
        n = y.shape[0] * y.shape[1]
        if reduce is not None:
            n = reduce(torch.tensor(float(n), device=y.device))
        bn_stats.append((p, *stats, n))


# -----------------------------------------------------------------------------
# Encoder


def encode(
    params: Params,
    cfg: Tacotron2Config,
    ids: torch.Tensor,
    lengths: typing.Optional[torch.Tensor] = None,
    train: bool = False,
    keep: typing.Optional[torch.Tensor] = None,
    bn_stats: typing.Optional[list] = None,
    reduce=None,
):
    """ids [B, T] -> (memory [B, T, E], mask [B, T] float {0, 1}).

    Padded positions are zeroed between stages and excluded from attention
    by the mask, so a padded row matches the same row run alone.  In
    ``train`` mode the BatchNorms take the batch's statistics, each
    appended as (bn params, mean, var, n) to ``bn_stats`` if given, and with
    ``keep`` [n_conv, B, T, E] (bool) each conv's ReLU output goes through
    dropout 0.5: ``where(keep, x / 0.5, 0)``; ``reduce`` makes the
    statistics global (:func:`_bn`)."""
    bsz, t = ids.shape
    if lengths is None:
        lengths = torch.full((bsz,), t, dtype=torch.int32, device=ids.device)
    mask = sequence_mask(lengths, t)
    mask1 = mask[..., None]

    x = params["embedding"][ids]  # [B, T, E]
    for i, conv in enumerate(params["encoder"]["convs"]):
        x, stats = _bn(conv["bn"], conv1d(x * mask1, conv["w"], conv["b"]), train, reduce=reduce)
        _collect(bn_stats, conv["bn"], stats, x, reduce)
        x = torch.relu(x)
        if train and keep is not None:
            x = torch.where(keep[i], x / 0.5, 0.0)
    x = x * mask1
    fw = _lstm_scan(params["encoder"]["lstm_fw"], x, mask=mask)
    bw = _lstm_scan(params["encoder"]["lstm_bw"], x, reverse=True, mask=mask)
    return torch.cat([fw, bw], dim=-1) * mask1, mask


# -----------------------------------------------------------------------------
# Decoder


_draw_pool = None
_draw_pool_lock = threading.Lock()


def _keep_draw_pool() -> concurrent.futures.ThreadPoolExecutor:
    global _draw_pool
    with _draw_pool_lock:
        if _draw_pool is None:
            _draw_pool = concurrent.futures.ThreadPoolExecutor(
                KEEP_DRAW_THREADS, thread_name_prefix="keep-masks")
        return _draw_pool


class RowKeepMasks:
    """The prenet keep masks of a batch's rows, drawn on the CPU a block of
    steps at a time: row r keeps u < 1 - p, with u [steps, 2, prenet_dim]
    uniform from a ``torch.Generator`` seeded by
    ``SeedSequence(entropies[r])`` (None: a padding row, all False).
    ``masks[a:b]`` -> [b - a, 2, B, prenet_dim] bool on ``device`` (None:
    the CPU), the blocks asked for in order.  The CPU generator fills u in
    order, so the blocks join into one draw, whatever their sizes and
    however many steps are drawn.  The rows are drawn side by side (each
    from its own generator, :data:`KEEP_DRAW_THREADS` threads); for a CUDA
    device into one of two pinned staging buffers, reused once the copy
    out of it has ended, so no block allocates or stacks on the host."""

    def __init__(self, cfg: Tacotron2Config,
                 entropies: typing.Sequence[typing.Optional[typing.Sequence[int]]], device=None):
        self.cfg, self.device = cfg, device
        self._gens = []
        for entropy in entropies:
            gen = None
            if entropy is not None:
                state = np.random.SeedSequence(
                    [int(e) & 0xFFFFFFFF for e in entropy]).generate_state(1)
                gen = torch.Generator().manual_seed(int(state[0]))
            self._gens.append(gen)
        self._drawn = 0
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._staging = collections.deque()  # [pinned buffer, its copy's event], oldest first

    def _buffer(self, shape) -> torch.Tensor:
        """A host tensor to draw a block into: on CUDA the older of the two
        staging buffers once its copy has ended (a new one while fewer than
        two, or the older too short)."""
        if not self._cuda:
            return torch.empty(shape, dtype=torch.bool)
        buf = None
        if len(self._staging) == 2:
            buf, event = self._staging.popleft()
            if buf.shape[0] < shape[0]:
                buf = None
            elif event is not None:
                event.synchronize()
        if buf is None:
            buf = torch.empty((max(shape[0], STOP_CHECK_STEPS), *shape[1:]), dtype=torch.bool,
                              pin_memory=True)
        self._staging.append([buf, None])
        return buf[: shape[0]]

    def __getitem__(self, steps: slice) -> torch.Tensor:
        if steps.start != self._drawn:
            raise ValueError(f"keep masks drawn from step {self._drawn}, asked from {steps.start}")
        shape = (steps.stop - steps.start, 2, self.cfg.prenet_dim)
        out = self._buffer((shape[0], 2, len(self._gens), shape[2]))
        keep = 1.0 - self.cfg.p_prenet_dropout
        inference = torch.is_inference_mode_enabled()  # the pool's threads take the caller's

        def draw(r):
            gen = self._gens[r]
            with torch.inference_mode(inference):
                if gen is None:
                    out[:, :, r].zero_()
                else:
                    torch.lt(torch.rand(shape, generator=gen), keep, out=out[:, :, r])

        if len(self._gens) > 1:
            list(_keep_draw_pool().map(draw, range(len(self._gens))))
        else:
            draw(0)
        self._drawn = steps.stop
        if not self._cuda:
            return out if self.device is None else out.to(self.device)
        dev = out.to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev.device))
        self._staging[-1][1] = event
        return dev


def row_keep_masks(
    cfg: Tacotron2Config, steps: int,
    entropies: typing.Sequence[typing.Optional[typing.Sequence[int]]],
) -> torch.Tensor:
    """The first ``steps`` of :class:`RowKeepMasks`, [steps, 2, B, prenet_dim]
    bool on the CPU."""
    return RowKeepMasks(cfg, entropies)[0:steps]


def draw_keep_masks(cfg: Tacotron2Config, max_steps: int, bsz: int, seed: int) -> torch.Tensor:
    """The whole decode's prenet keep masks, [max_steps, 2, B, prenet_dim]
    bool on the CPU: row r's from ``SeedSequence([seed, r])``
    (:func:`row_keep_masks`); row 0's are ``SeedSequence([seed])``'s, since
    a trailing zero word leaves a SeedSequence's state as it was."""
    return row_keep_masks(cfg, max_steps, [[seed, r] for r in range(bsz)])


def _prenet(p, x: torch.Tensor, keep: typing.Optional[torch.Tensor], p_dropout: float):
    """Two ReLU linears with always-on dropout (the NVIDIA quirk); ``keep``
    [2, *x.shape[:-1], prenet_dim] holds the masks of x's rows (one step's
    [2, B, P] at inference, the whole teacher input's [2, B, S, P] in
    training)."""
    for i, layer in enumerate(p):
        x = torch.relu(F.linear(x, layer["w"]))
        if p_dropout > 0.0 and keep is not None:
            x = torch.where(keep[i], x / (1.0 - p_dropout), 0.0)
    return x


def _attention(att: Params, query, memory, processed_memory, attn_cat, mask):
    """Location-sensitive attention.

    query [B, A_rnn]; attn_cat [B, T, 2] (current and cumulative weights).
    Returns (context [B, E], weights [B, T])."""
    loc = conv1d(attn_cat, att["location_conv"])  # 'same' padding
    processed = (
        F.linear(query, att["query"]["w"])[:, None, :]
        + F.linear(loc, att["location_dense"]["w"])
        + processed_memory
    )
    energies = F.linear(torch.tanh(processed), att["v"]["w"]).squeeze(-1)  # [B, T]
    energies = torch.where(mask > 0, energies, _MASK_VALUE)
    weights = torch.softmax(energies, dim=-1)
    context = torch.bmm(weights[:, None, :], memory).squeeze(1)
    return context, weights


def _decoder_state0(cfg: Tacotron2Config, bsz: int, t: int, like: torch.Tensor) -> dict:
    def zeros(*shape):
        return like.new_zeros(shape)

    return {
        "attn_h": zeros(bsz, cfg.attention_rnn_dim),
        "attn_c": zeros(bsz, cfg.attention_rnn_dim),
        "dec_h": zeros(bsz, cfg.decoder_rnn_dim),
        "dec_c": zeros(bsz, cfg.decoder_rnn_dim),
        "attn_w": zeros(bsz, t),
        "attn_w_cum": zeros(bsz, t),
        "context": zeros(bsz, cfg.encoder_embedding_dim),
    }


def _decoder_step(
    params: Params,
    cfg: Tacotron2Config,
    state: dict,
    prenet_out: torch.Tensor,
    memory: torch.Tensor,
    processed_memory: torch.Tensor,
    mask: torch.Tensor,
):
    """One frame: returns (new_state, mel_frame [B, M], gate_logit [B])."""
    dec = params["decoder"]
    cell_in = torch.cat([prenet_out, state["context"]], dim=-1)
    attn_h, attn_c = lstm_cell(dec["attention_rnn"], cell_in, state["attn_h"], state["attn_c"])
    attn_cat = torch.stack([state["attn_w"], state["attn_w_cum"]], dim=-1)
    context, weights = _attention(
        dec["attention"], attn_h, memory, processed_memory, attn_cat, mask
    )
    dec_h, dec_c = lstm_cell(
        dec["decoder_rnn"], torch.cat([attn_h, context], dim=-1), state["dec_h"], state["dec_c"]
    )
    proj_in = torch.cat([dec_h, context], dim=-1)
    mel = F.linear(proj_in, dec["projection"]["w"], dec["projection"]["b"])
    gate = F.linear(proj_in, dec["gate"]["w"], dec["gate"]["b"]).squeeze(-1)
    new_state = {
        "attn_h": attn_h,
        "attn_c": attn_c,
        "dec_h": dec_h,
        "dec_c": dec_c,
        "attn_w": weights,
        "attn_w_cum": state["attn_w_cum"] + weights,
        "context": context,
    }
    return new_state, mel, gate


def pack_params(params: Params, cfg: Tacotron2Config) -> Params:
    """``params`` with the decoder step kernel's weights
    (``ops/tacotron2_step.py::pack_decoder``) as ``decoder["step_kernel"]``
    when they lie on a CUDA device; CPU params come back as they are."""
    dec = params["decoder"]
    if dec["projection"]["w"].device.type != "cuda":
        return params
    packed = tacotron2_step.pack_decoder(dec, cfg.p_prenet_dropout)
    return {**params, "decoder": {**dec, "step_kernel": packed}}


def postnet_halo(cfg: Tacotron2Config) -> int:
    """Frames past a row's last one that its postnet output reads: each of
    the postnet's 'same' convs reaches k // 2 frames ahead (10 at 5 x k5)."""
    return cfg.postnet_n_convolutions * (cfg.postnet_kernel_size // 2)


def _read_host(stops: torch.Tensor) -> np.ndarray:
    return stops.cpu().numpy()


def decode_steps(
    params: Params,
    cfg: Tacotron2Config,
    state: dict,
    prev: torch.Tensor,
    memory: torch.Tensor,
    processed_memory: torch.Tensor,
    mask: torch.Tensor,
    n: int,
    keep: typing.Optional[torch.Tensor] = None,
):
    """``n`` decoder steps from ``state`` and the last frame ``prev`` ->
    (state, last frame, mels [B, n, M], gate logits [B, n]); ``keep``
    [n, 2, B, prenet_dim] (bool) or None.  On a CUDA device the steps run in
    the step kernel (one launch), on params from :func:`pack_params`."""
    dec = params["decoder"]
    if memory.device.type == "cuda":
        packed = dec.get("step_kernel")
        if packed is None:
            raise ValueError("decoder steps on CUDA need the step kernel's weights: "
                             "pack the params with pack_params")
        return tacotron2_step.decode_steps(packed, state, prev, memory, processed_memory, mask,
                                           n, keep)
    mels, gates = [], []
    for i in range(n):
        pre = _prenet(dec["prenet"], prev, None if keep is None else keep[i],
                      cfg.p_prenet_dropout)
        state, prev, gate = _decoder_step(params, cfg, state, pre, memory, processed_memory, mask)
        mels.append(prev)
        gates.append(gate)
    return state, prev, torch.stack(mels, dim=1), torch.stack(gates, dim=1)


def decode_blocked(
    params: Params,
    cfg: Tacotron2Config,
    memory: torch.Tensor,
    mask: torch.Tensor,
    caps: np.ndarray,
    keep_masks: typing.Optional[torch.Tensor] = None,
    block: int = STOP_CHECK_STEPS,
    read: typing.Callable[[torch.Tensor], np.ndarray] = _read_host,
    ahead: typing.Optional[bool] = None,
):
    """Autoregressive decode of a batch whose row r stops at its gate or
    at ``caps[r]`` steps (0: a padding row, stopped from the start).

    A row's length counts frames up to and including its stop frame, as
    the JAX package's ``decode_inference`` counts them.  The stops [B]
    int32 (-1 while a row runs) stay on the device; after every ``block``
    steps ``read`` copies them to the host, and the decode ends at the
    first block boundary where every row is done: its stop plus
    :func:`postnet_halo` frames decoded, or its cap reached; never past
    ``max(caps)``.  A row's frames up to that point
    are those of its own decode over all of its cap's steps, so with the
    postnet masked at the caps (:func:`postnet`'s ``mask``) its frames up
    to its stop are too.  ``keep_masks``: [max(caps), 2, B, prenet_dim] on
    the device, or :class:`RowKeepMasks`, whose next block the host draws
    while the card runs this one; or None.  Each block's steps run in
    :func:`decode_steps` (on CUDA, one launch of the step kernel).

    ``ahead`` (default: on a CUDA device) launches the next block before a
    block's stops are read, so that the card runs it while the host reads
    and draws: the read then waits on an event behind the block's stops, on
    a stream of its own, and a block launched past the end is dropped.
    Returns (mels [B, S, M], lengths [B] numpy, S, blocks read)."""
    dec = params["decoder"]
    bsz, t, _ = memory.shape
    budget = int(np.max(caps))
    if ahead is None:
        ahead = memory.device.type == "cuda"
    side = torch.cuda.Stream(memory.device) if ahead and memory.device.type == "cuda" else None
    caps_dev = to_device(np.asarray(caps, dtype=np.int32), memory.device)
    processed_memory = F.linear(memory, dec["attention"]["memory"]["w"])
    state = _decoder_state0(cfg, bsz, t, memory)
    prev = memory.new_zeros((bsz, cfg.mel_channels))
    stops = torch.where(caps_dev > 0, -1, 0).to(torch.int32)
    halo = postnet_halo(cfg)
    mels, inflight = [], collections.deque()  # (end, stops, event) of blocks not read yet
    launched = steps = blocks = 0
    keep_next = None if keep_masks is None else keep_masks[0:min(block, budget)]

    def launch():
        nonlocal state, prev, stops, launched, keep_next
        end = min(launched + block, budget)
        state, prev, mel, gates = decode_steps(
            params, cfg, state, prev, memory, processed_memory, mask, end - launched, keep_next)
        mels.append(mel)
        frame = torch.arange(launched + 1, end + 1, device=memory.device, dtype=torch.int32)
        fired = (torch.sigmoid(gates) > cfg.gate_threshold) \
            | (frame[None, :] >= caps_dev[:, None])
        first = fired.to(torch.int8).argmax(dim=1).to(torch.int32) + (launched + 1)
        stops = torch.where((stops < 0) & fired.any(dim=1), first, stops)
        event = None
        if side is not None:
            event = torch.cuda.Event()
            event.record()
        inflight.append((end, stops, event))
        launched = end
        if keep_masks is not None and end < budget:
            keep_next = keep_masks[end:min(end + block, budget)]

    launch()
    while True:
        if ahead and launched < budget:
            launch()
        steps, done, event = inflight.popleft()
        blocks += 1
        if event is None:
            lengths = read(done)
        else:
            with torch.cuda.stream(side):
                side.wait_event(event)
                lengths = read(done)
        if steps >= budget or np.all((lengths >= 0) & (steps >= np.minimum(lengths + halo, caps))):
            break
        if not ahead:
            launch()
    mel = torch.cat(mels, dim=1)
    return (mel if mel.shape[1] == steps else mel[:, :steps]), lengths, steps, blocks


def decode_teacher(
    params: Params,
    cfg: Tacotron2Config,
    memory: torch.Tensor,
    mask: torch.Tensor,
    mel_targets: torch.Tensor,
    keep: typing.Optional[torch.Tensor] = None,
):
    """Teacher-forced decode for training: the decoder's inputs are the go
    frame, then the targets [B, S, M] shifted right by one frame.  The
    prenet runs over all S inputs at once (it has no state across steps),
    with ``keep`` [2, B, S, prenet_dim] (bool) as its dropout masks; then
    one ``_decoder_step`` per frame.  Returns (mels [B, S, M], gate_logits
    [B, S])."""
    dec = params["decoder"]
    bsz, t, _ = memory.shape
    processed_memory = F.linear(memory, dec["attention"]["memory"]["w"])
    state = _decoder_state0(cfg, bsz, t, memory)
    go = mel_targets.new_zeros((bsz, 1, cfg.mel_channels))
    inputs = torch.cat([go, mel_targets[:, :-1]], dim=1)
    pre = _prenet(dec["prenet"], inputs, keep, cfg.p_prenet_dropout)  # [B, S, P]
    mels, gates = [], []
    for i in range(pre.shape[1]):
        state, mel, gate = _decoder_step(
            params, cfg, state, pre[:, i], memory, processed_memory, mask
        )
        mels.append(mel)
        gates.append(gate)
    return torch.stack(mels, dim=1), torch.stack(gates, dim=1)


# -----------------------------------------------------------------------------
# Postnet + top level


def postnet(params: Params, cfg: Tacotron2Config, mels: torch.Tensor, train: bool = False,
            bn_stats: typing.Optional[list] = None, reduce=None,
            mask: typing.Optional[torch.Tensor] = None) -> torch.Tensor:
    """5-conv residual refiner: mels [B, S, M] -> residual [B, S, M]; in
    ``train`` mode with batch statistics, as :func:`encode`.  ``mask``
    [B, S] zeroes each conv's input where it is 0, as the end of a shorter
    decode would: row r then reads as its own decode of its first
    ``mask[r].sum()`` frames."""
    x = mels
    convs = params["postnet"]["convs"]
    keep = None if mask is None else mask[..., None]
    for i, conv in enumerate(convs):
        if keep is not None:
            x = x * keep
        x, stats = _bn(conv["bn"], conv1d(x, conv["w"], conv["b"]), train, reduce=reduce)
        _collect(bn_stats, conv["bn"], stats, x, reduce)
        if i < len(convs) - 1:
            x = torch.tanh(x)
    return x


def infer(
    params: Params,
    cfg: Tacotron2Config,
    ids: torch.Tensor,
    lengths: typing.Optional[torch.Tensor] = None,
    max_steps: typing.Optional[int] = None,
    keep_masks: typing.Optional[torch.Tensor] = None,
):
    """Full inference: ids [B, T] -> (mel_post [B, S, M], lengths [B] int32),
    every row capped at ``max_steps`` (the config's when None); the decode
    ends early as :func:`decode_blocked` does, so S <= ``max_steps``, and a
    row's frames up to its stop are those of the whole budget's decode."""
    if max_steps is None:
        max_steps = cfg.max_decoder_steps
    memory, mask = encode(params, cfg, ids, lengths)
    mels, out_lengths, _steps, _blocks = decode_blocked(
        params, cfg, memory, mask, np.full((ids.shape[0],), max_steps), keep_masks)
    return mels + postnet(params, cfg, mels), torch.as_tensor(out_lengths, dtype=torch.int32)


def forward_teacher(
    params: Params,
    cfg: Tacotron2Config,
    ids: torch.Tensor,
    id_lengths: torch.Tensor,
    mel_targets: torch.Tensor,
    train: bool = True,
    encoder_keep: typing.Optional[torch.Tensor] = None,
    prenet_keep: typing.Optional[torch.Tensor] = None,
    bn_stats: typing.Optional[list] = None,
    reduce=None,
):
    """Training forward: (mel_pre, mel_post, gate_logits).  The keep masks
    ([n_conv, B, T, E] and [2, B, S, prenet_dim], bool) switch the two
    dropouts on; ``bn_stats`` collects the BatchNorms' batch statistics,
    global ones with ``reduce`` (data parallel)."""
    memory, mask = encode(params, cfg, ids, id_lengths, train=train, keep=encoder_keep,
                          bn_stats=bn_stats, reduce=reduce)
    mels, gates = decode_teacher(params, cfg, memory, mask, mel_targets, keep=prenet_keep)
    return mels, mels + postnet(params, cfg, mels, train=train, bn_stats=bn_stats,
                                reduce=reduce), gates
