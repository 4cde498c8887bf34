"""Signal layer: QAM and OFDM codecs, channels, RF impairments, the
synthetic datagen and the image-backed datasets."""
