"""Evaluation: signal-quality metrics, the classical equalizers, the
GAN-versus-classical SNR sweep, BER and the distributional metrics."""
