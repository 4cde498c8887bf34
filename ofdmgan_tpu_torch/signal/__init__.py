"""Synthetic OFDM frames: the spectrum, impairments, channel and datagen."""
