"""Quantization and the fixed-point deployment path: Q-formats
(``qformat``), straight-through fake quantization (``fakequant``), the FPGA
export bundle (``export``), the bit-true Q1.7/Q8.8 integer datapath
(``intsim``) and the Verilog weight ROM (``rom_codegen``)."""
