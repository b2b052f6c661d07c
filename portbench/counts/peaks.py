"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): the rates every roofline share and MFU is taken against."""

BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
TF32_PER_F32 = 3  # a float32 product on TF32 tensor cores as hi/lo parts: 3 operations a FLOP
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops, nbytes, itemsize):
    """The least time of a kernel: its operations at the dtype's tensor-core
    peak or its bytes at HBM bandwidth, whichever is longer."""
    ops = flops / BF16_FLOPS if itemsize == 2 else TF32_PER_F32 * flops / TF32_FLOPS
    return max(ops, nbytes / HBM_BYTES_PER_S)
