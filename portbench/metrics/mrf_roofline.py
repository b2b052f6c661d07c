"""The bf16 MRF sections' share of their roofline: the sum of each
``mrf_section`` call's bound (from its shapes) over the device time of the
operations launched inside the ``mrf_section`` ranges."""

from portbench.counts import mrf, peaks


def read(ctx):
    device_s = ctx.trace.device_s("mrf_section")
    if not ctx.mrf_calls or device_s <= 0:
        return None
    bound = 0.0
    for c, b, t, itemsize, stage in ctx.mrf_calls:
        taps = mrf.section_taps(stage.kernel_sizes, stage.dilations_per_block, stage.convs_per_unit)
        bound += peaks.bound_s(
            mrf.section_flops(b, t, c, taps),
            mrf.section_bytes(b, t, c, stage.kernel_sizes, stage.dilations_per_block,
                              stage.convs_per_unit, itemsize),
            itemsize)
    return 100.0 * bound / device_s
