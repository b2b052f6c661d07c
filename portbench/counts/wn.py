"""Operations and bytes of one WaveGlow WN layer with its state update:
the dilated conv (3 taps) and the conditioning 1x1 into 2ch gates, the
tanh-sigmoid gate, the res/skip 1x1 into rs_out channels."""


def layer_flops(b, t, ch, cc, rs_out, taps=3):
    return 2.0 * b * t * (2 * ch * (taps * ch + cc) + ch * rs_out)


def layer_bytes(b, t, ch, cc, rs_out, first, last, weights, itemsize):
    """h and cond read, h written (except the last layer), skip read
    (except the first) and written, and the weights (``weights`` elements:
    conv, cond 1x1, res/skip 1x1 and biases), each once, in the kernel's
    dtype."""
    act = b * t * ch
    io = act + b * t * cc + act + (0 if first else act) + (0 if last else act)
    return itemsize * (io + weights)
