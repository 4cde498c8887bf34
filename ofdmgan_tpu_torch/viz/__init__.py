"""Signal scenarios, the image-transmission study and architecture diagrams
(counterpart of ``ofdmgan_tpu/viz``). The arithmetic needs only numpy and
torch; the figures import matplotlib when they are drawn."""
