"""Operations and bytes of Tacotron2's autoregressive decoder step over a
batch, and the step's roofline bound.

A step reads every decoder weight once (the prenet, both LSTM cells with
their one summed bias each, the attention's query, location conv and dense, v, the
projection and the gate; the memory's projection is made once before the
loop), and its rows' memory and processed memory at the text bucket; it
reads and writes its state (both cells' h and c, the context, the
attention weights and their sum, the last frame).  Everything is float32,
as the port runs Tacotron2; its products run on CUDA cores (TF32 off), so
the peak is the card's float32 rate.
"""

from portbench.counts import peaks

F32_FLOPS = 67e12  # one NVIDIA H100 SXM, float32 on CUDA cores (NVIDIA's data sheet)
ITEMSIZE = 4


def step_weights(cfg):
    """Weights a decoder step reads (18.18 M at NVIDIA's hparams)."""
    e, p, m = cfg["encoder_embedding_dim"], cfg["prenet_dim"], cfg["mel_channels"]
    a_rnn, d_rnn, a = cfg["attention_rnn_dim"], cfg["decoder_rnn_dim"], cfg["attention_dim"]
    f, k = cfg["attention_location_n_filters"], cfg["attention_location_kernel_size"]
    prenet = m * p + p * p
    attention_rnn = 4 * a_rnn * (p + e + a_rnn + 1)
    attention = a * a_rnn + f * 2 * k + a * f + a
    decoder_rnn = 4 * d_rnn * (a_rnn + e + d_rnn + 1)
    out = (m + 1) * (d_rnn + e + 1)
    return prenet + attention_rnn + attention + decoder_rnn + out


def step_macs(cfg, t):
    """Multiply-adds of one row's step over a memory of ``t`` positions:
    every weight once, the location conv and dense, v and the context
    over the positions."""
    f, k = cfg["attention_location_n_filters"], cfg["attention_location_kernel_size"]
    a, e = cfg["attention_dim"], cfg["encoder_embedding_dim"]
    per_position = 2 * k * f + f * a + a + e
    return step_weights(cfg) + t * per_position


def step_flops(cfg, rows, t):
    return 2.0 * rows * step_macs(cfg, t)


def step_bytes(cfg, rows, t):
    state = 2 * cfg["attention_rnn_dim"] + 2 * cfg["decoder_rnn_dim"] \
        + cfg["encoder_embedding_dim"] + 2 * t + cfg["mel_channels"]
    memory = t * (cfg["encoder_embedding_dim"] + cfg["attention_dim"])
    return ITEMSIZE * (step_weights(cfg) + rows * (memory + 2 * state))


def step_bound_s(cfg, rows, t):
    """The least time of one decoder step of ``rows`` rows at text bucket
    ``t``: its FLOPs at the float32 peak or its bytes at HBM bandwidth."""
    return max(step_flops(cfg, rows, t) / F32_FLOPS,
               step_bytes(cfg, rows, t) / peaks.HBM_BYTES_PER_S)


def encode_macs(cfg, n_ids):
    """The encoder over ``n_ids`` ids: the convs, the BiLSTM and the
    memory's projection for the attention."""
    e, k = cfg["encoder_embedding_dim"], cfg["encoder_kernel_size"]
    h = e // 2
    convs = cfg["encoder_n_convolutions"] * k * e * e
    bilstm = 2 * 4 * h * (e + h)
    return n_ids * (convs + bilstm + e * cfg["attention_dim"])


def postnet_macs(cfg, frames):
    c, k, m = cfg["postnet_embedding_dim"], cfg["postnet_kernel_size"], cfg["mel_channels"]
    n = cfg["postnet_n_convolutions"]
    return frames * k * (m * c + (n - 2) * c * c + c * m)
