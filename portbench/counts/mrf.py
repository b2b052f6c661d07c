"""Operations and bytes of one multi-receptive-field section (the mean of a
HiFi-GAN stage's resblocks) on [B, T, C] activations."""


def section_taps(kernel_sizes, dilations, convs_per_unit):
    """Conv taps summed over the section's convs: ResBlock1 units hold a
    dilated and a plain conv of the same kernel (126 for (3, 7, 11) x (1,
    3, 5))."""
    return sum(k * len(d) * convs_per_unit for k, d in zip(kernel_sizes, dilations))


def section_flops(b, t, c, taps):
    """2 * B * T * C^2 * taps: every conv is C x C per tap."""
    return 2.0 * b * t * c * c * taps


def section_bytes(b, t, c, kernel_sizes, dilations, convs_per_unit, itemsize):
    """The input read once, the output written once, each conv's weights and
    bias once, in the kernel's dtype."""
    taps = section_taps(kernel_sizes, dilations, convs_per_unit)
    n_convs = sum(len(d) * convs_per_unit for d in dilations)
    return itemsize * (2 * b * t * c + c * c * taps + c * n_convs)
