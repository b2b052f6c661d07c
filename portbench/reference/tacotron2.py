"""Tacotron2 inference in plain PyTorch, written from NVIDIA's published
code (github.com/NVIDIA/tacotron2, ``model.py``): the embedding, three
conv + BatchNorm + ReLU layers and a BiLSTM encoder; a decoder whose every
step runs the prenet (two bias-free ReLU linears, dropout on at inference),
the attention LSTM cell over [prenet, context], location-sensitive
attention (a 'same' bias-free location conv over [weights, cumulative
weights], its dense, tanh, v, the masked softmax, the context), the decoder
LSTM cell over [attention hidden, context], and the mel projection and gate
over [decoder hidden, context]; then ``mel + postnet(mel)``, the postnet
five conv + BatchNorm layers, tanh between them.  Each ``LSTMCell`` keeps
torch's gate order i, f, g, o and both of its biases; BatchNorm takes its
running statistics (eval).

Each row runs alone, at its own length, in the dtype of the parameters it
is given (float64 for the check).  Parameters in the port's layout (convs
[C_out, C_in, k], linears [out, in], LSTM ``w_ih`` [4H, in], ``w_hh`` [4H,
H], and NVIDIA's ``b_ih`` and ``b_hh``).

Where this departs from NVIDIA's ``inference``:

- the prenet's dropout masks are given (``keep`` [steps, 2, prenet_dim],
  drawn by the engine's rule, ``ar_rules.py``), where NVIDIA draws them anew
  with ``F.dropout(training=True)``;
- a row decodes all of its ``cap`` steps (its own step cap, where NVIDIA has
  one ``max_decoder_steps``) and its length is the frame at which its gate
  first fires, that frame included, or the cap; the postnet reads the frames
  past the stop as well, as the port's and the JAX package's decodes do,
  where NVIDIA's loop breaks at the stop and its postnet reads zeros there;
- no attention or decoder dropout, as NVIDIA at inference.
"""

import torch
import torch.nn.functional as F


def _conv(x, p, bias=True):
    """x [B, C, T] -> [B, C_out, T], 'same' padding."""
    w = p["w"]
    return F.conv1d(x, w, p["b"] if bias else None, padding=(w.shape[-1] - 1) // 2)


def _bn(x, p, eps=1e-5):
    return (x - p["mean"][:, None]) / torch.sqrt(p["var"][:, None] + eps) * p["gamma"][:, None] \
        + p["beta"][:, None]


def _lstm_cell(p, x, h, c):
    gates = x @ p["w_ih"].T + p["b_ih"] + h @ p["w_hh"].T + p["b_hh"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _lstm(p, x, reverse=False):
    """x [T, C] -> h [T, H] of one direction."""
    hidden = p["w_hh"].shape[1]
    h = x.new_zeros((1, hidden))
    c = x.new_zeros((1, hidden))
    out = [None] * x.shape[0]
    steps = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
    for t in steps:
        h, c = _lstm_cell(p, x[t : t + 1], h, c)
        out[t] = h[0]
    return torch.stack(out)


def encode(params, ids):
    """One row's ids [T] -> memory [T, E]."""
    x = params["embedding"][ids].T[None]  # [1, E, T]
    for conv in params["encoder"]["convs"]:
        x = torch.relu(_bn(_conv(x, conv), conv["bn"]))
    x = x[0].T
    return torch.cat([_lstm(params["encoder"]["lstm_fw"], x),
                      _lstm(params["encoder"]["lstm_bw"], x, reverse=True)], dim=-1)


def _attention(att, query, memory, processed_memory, weights_cat):
    """query [1, A_rnn], weights_cat [1, 2, T] -> (context [1, E], weights [1, T])."""
    loc = F.conv1d(weights_cat, att["location_conv"],
                   padding=(att["location_conv"].shape[-1] - 1) // 2)  # [1, F, T]
    processed = (query @ att["query"]["w"].T)[:, None, :] \
        + loc.transpose(1, 2) @ att["location_dense"]["w"].T + processed_memory[None]
    energies = (torch.tanh(processed) @ att["v"]["w"].T)[..., 0]  # [1, T]
    weights = torch.softmax(energies, dim=-1)
    return weights @ memory, weights


def decode(params, cfg, memory, keep, cap):
    """One row's decode over ``cap`` steps -> (mels [cap, M], gate logits
    [cap], length).  ``keep`` [>= cap, 2, prenet_dim] bool, or None for no
    dropout."""
    dec = params["decoder"]
    t = memory.shape[0]
    processed_memory = memory @ dec["attention"]["memory"]["w"].T
    zeros = lambda *s: memory.new_zeros(s)  # noqa: E731
    attn_h, attn_c = zeros(1, cfg["attention_rnn_dim"]), zeros(1, cfg["attention_rnn_dim"])
    dec_h, dec_c = zeros(1, cfg["decoder_rnn_dim"]), zeros(1, cfg["decoder_rnn_dim"])
    weights, weights_cum = zeros(1, t), zeros(1, t)
    context = zeros(1, memory.shape[1])
    prev = zeros(1, cfg["mel_channels"])
    p = cfg["p_prenet_dropout"]
    mels, gates = [], []
    for i in range(cap):
        x = prev
        for layer, lin in enumerate(dec["prenet"]):
            x = torch.relu(x @ lin["w"].T)
            if keep is not None and p > 0.0:
                x = torch.where(keep[i, layer][None], x / (1.0 - p), 0.0)
        attn_h, attn_c = _lstm_cell(dec["attention_rnn"], torch.cat([x, context], -1),
                                    attn_h, attn_c)
        context, weights = _attention(dec["attention"], attn_h, memory, processed_memory,
                                      torch.stack([weights, weights_cum], dim=1))
        weights_cum = weights_cum + weights
        dec_h, dec_c = _lstm_cell(dec["decoder_rnn"], torch.cat([attn_h, context], -1),
                                  dec_h, dec_c)
        out = torch.cat([dec_h, context], -1)
        prev = out @ dec["projection"]["w"].T + dec["projection"]["b"]
        mels.append(prev[0])
        gates.append((out @ dec["gate"]["w"].T + dec["gate"]["b"])[0, 0])
    gates = torch.stack(gates)
    fired = torch.nonzero(torch.sigmoid(gates) > cfg["gate_threshold"])
    length = int(fired[0, 0]) + 1 if len(fired) else cap
    return torch.stack(mels), gates, length


def postnet(params, mels):
    """mels [S, M] -> mels + the postnet's residual, [S, M]."""
    x = mels.T[None]
    convs = params["postnet"]["convs"]
    for i, conv in enumerate(convs):
        x = _bn(_conv(x, conv), conv["bn"])
        if i < len(convs) - 1:
            x = torch.tanh(x)
    return mels + x[0].T


def infer(params, cfg, ids, keep, cap):
    """One row alone -> (mel [cap, M] after the postnet, length)."""
    memory = encode(params, ids)
    mels, _gates, length = decode(params, cfg, memory, keep, cap)
    return postnet(params, mels), length
