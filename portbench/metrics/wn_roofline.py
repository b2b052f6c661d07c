"""The WN layer kernel's share of its roofline: the sum of each
``fused_wn_layer_state`` call's bound (from its shapes) over the device time
of the operations launched inside those ranges."""

from portbench.counts import peaks, wn


def read(ctx):
    device_s = ctx.trace.device_s("fused_wn_layer_state")
    if not ctx.wn_calls or device_s <= 0:
        return None
    bound = 0.0
    for b, t, layer, first, last in ctx.wn_calls:
        ch = layer.w_in.shape[1]
        cc = layer.w_cond.shape[1]
        rs_out = layer.b_rs.numel()
        n_weights = (layer.w_in.numel() + layer.w_cond.numel() + layer.w_rs.numel()
                     + layer.bias_a.numel() + rs_out)
        itemsize = layer.w_in.element_size()
        bound += peaks.bound_s(wn.layer_flops(b, t, ch, cc, rs_out),
                               wn.layer_bytes(b, t, ch, cc, rs_out, first, last, n_weights,
                                              itemsize), itemsize)
    return 100.0 * bound / device_s
