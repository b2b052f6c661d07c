"""PyTorch model implementations (GlowTTS acoustic model, HiFi-GAN vocoder)."""
