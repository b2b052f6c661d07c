"""The whole synthesis's share of the card's bf16 dense peak: the model
FLOPs of the valid ids, frames and samples of the traced window's requests
(``counts/model.py``) over the window's wall time and 989 TFLOP/s."""

from portbench.counts import model, peaks


def read(ctx):
    if not ctx.requests or ctx.window_s <= 0:
        return None
    flops = sum(model.request_flops(ctx.config, n_ids, frames) for n_ids, frames in ctx.requests)
    return 100.0 * flops / (ctx.window_s * peaks.BF16_FLOPS)
