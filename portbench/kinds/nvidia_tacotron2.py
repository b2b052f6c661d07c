"""NVIDIA's Tacotron2, an autoregressive acoustic model (``acoustic.kind``
"nvidia_tacotron2").

Random weights in the port's init scales (``weights.py::_init_tacotron2``:
xavier-uniform linears, uniform 1/sqrt(in) biases, xavier-over-taps convs
with zero biases, identity BatchNorm statistics), with each LSTM cell's two
biases drawn as NVIDIA's checkpoints hold them (uniform 1/sqrt(H) each, the
init of torch's ``LSTMCell``): the reference reads ``b_ih`` and ``b_hh``,
the port their sum ``b``.  :func:`calibrate` sets two layers, each because
the init would not give a voice's output:

- the gate's bias to ``GATE_BIAS``: a random gate would stop a row at
  whatever frame its logit first crosses zero, so with -50 no row stops by
  chance and every row ends at its cap, the traffic's frames per id;
- the mel projection: its weights x ``PROJ_SCALE`` and its bias a line
  from ``MEL_MEAN[0]`` (the first channel) to ``MEL_MEAN[1]`` (the last).
  At the init's scale every frame lies within 0.06 of zero, where NVIDIA's
  log-mels (log of the clamped magnitude) span about -11.5 to 2; so near
  zero a mel barely conditions WaveGlow, and a fault or a lower precision
  of the vocoder's products hardly reaches the audio.  At 30 x and a bias
  of -3.5 to -7.5 a frame's channels read mean -5.3, standard deviation
  2.5, from -16 to 5 (two rows of two seeds at NVIDIA's widths, on an
  H100).

The reference is ``reference/tacotron2.py`` (float64), under the engine's
rules in ``reference/ar_rules.py``.
"""

import math

import torch

from portbench.counts import tacotron2 as counts
from portbench.harness.weights import Draws

PORT_CONFIG = "larynx_tpu_torch.models.tacotron2.config:Tacotron2Config"
AUTOREGRESSIVE = True  # the output length is known only once the model has run
GATE_BIAS = -50.0
PROJ_SCALE = 30.0  # the mel projection's weights x this
MEL_MEAN = (-3.5, -7.5)  # the projection's bias, first channel to last, linear


def weights(cfg, gen, device, dtype=torch.float32):
    e, p, m = cfg["encoder_embedding_dim"], cfg["prenet_dim"], cfg["mel_channels"]
    a, f, k_loc = cfg["attention_dim"], cfg["attention_location_n_filters"], \
        cfg["attention_location_kernel_size"]
    zeros = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    ones = lambda *s: torch.ones(s, device=device)  # noqa: E731
    d = Draws()

    def linear(c_in, c_out, bias=True):
        box = {}
        d.uniform(box, "w", (c_out, c_in), math.sqrt(6.0 / (c_in + c_out)))
        if bias:
            d.uniform(box, "b", (c_out,), 1.0 / math.sqrt(c_in))
        return box

    def conv_bn(k, c_in, c_out):
        box = {"b": zeros(c_out), "bn": {"gamma": ones(c_out), "beta": zeros(c_out),
                                         "mean": zeros(c_out), "var": ones(c_out)}}
        d.uniform(box, "w", (c_out, c_in, k), math.sqrt(6.0 / (k * (c_in + c_out))))
        return box

    def lstm(c_in, hidden):
        box = {}
        bound = 1.0 / math.sqrt(hidden)
        d.uniform(box, "w_ih", (4 * hidden, c_in), bound)
        d.uniform(box, "w_hh", (4 * hidden, hidden), bound)
        d.uniform(box, "b_ih", (4 * hidden,), bound)
        d.uniform(box, "b_hh", (4 * hidden,), bound)
        return box

    n_post = cfg["postnet_n_convolutions"]
    post = [conv_bn(cfg["postnet_kernel_size"], m if i == 0 else cfg["postnet_embedding_dim"],
                    m if i == n_post - 1 else cfg["postnet_embedding_dim"]) for i in range(n_post)]
    params = {
        "encoder": {
            "convs": [conv_bn(cfg["encoder_kernel_size"], e, e)
                      for _ in range(cfg["encoder_n_convolutions"])],
            "lstm_fw": lstm(e, e // 2),
            "lstm_bw": lstm(e, e // 2),
        },
        "decoder": {
            "prenet": [linear(m, p, bias=False), linear(p, p, bias=False)],
            "attention_rnn": lstm(p + e, cfg["attention_rnn_dim"]),
            "attention": {
                "query": linear(cfg["attention_rnn_dim"], a, bias=False),
                "memory": linear(e, a, bias=False),
                "v": linear(a, 1, bias=False),
                "location_dense": linear(f, a, bias=False),
            },
            "decoder_rnn": lstm(cfg["attention_rnn_dim"] + e, cfg["decoder_rnn_dim"]),
            "projection": linear(cfg["decoder_rnn_dim"] + e, m),
            "gate": linear(cfg["decoder_rnn_dim"] + e, 1),
        },
        "postnet": {"convs": post},
    }
    std = math.sqrt(2.0 / (cfg["num_symbols"] + cfg["symbols_embedding_dim"]))
    d.uniform(params, "embedding", (cfg["num_symbols"], cfg["symbols_embedding_dim"]),
              math.sqrt(3.0) * std)
    d.uniform(params["decoder"]["attention"], "location_conv", (f, 2, k_loc),
              math.sqrt(6.0 / (k_loc * 2 + 2)))
    d.fill(gen, device, dtype)
    for cell in (params["encoder"]["lstm_fw"], params["encoder"]["lstm_bw"],
                 params["decoder"]["attention_rnn"], params["decoder"]["decoder_rnn"]):
        cell["b"] = cell["b_ih"] + cell["b_hh"]
    return params


def calibrate(params, cfg, ids, lengths, length_scale, frames_per_id):
    """Set the gate's bias to ``GATE_BIAS``, scale the mel projection's
    weights by ``PROJ_SCALE`` and set its bias to ``MEL_MEAN``."""
    proj = params["decoder"]["projection"]
    proj["w"].mul_(PROJ_SCALE)
    proj["b"].copy_(torch.linspace(*MEL_MEAN, cfg["mel_channels"], device=proj["b"].device))
    params["decoder"]["gate"]["b"].fill_(GATE_BIAS)


def flops(cfg, n_ids, frames):
    """A request's encode over its ids, its decoder steps over its valid
    frames (attention over its own ids) and the postnet over them."""
    return 2.0 * (counts.encode_macs(cfg, n_ids) + frames * counts.step_macs(cfg, n_ids)
                  + counts.postnet_macs(cfg, frames))
