"""Device-side DSP: mel post-processing and the denoiser's STFT."""
