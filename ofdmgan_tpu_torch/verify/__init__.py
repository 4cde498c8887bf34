"""Hardware verification and the FPGA handoff: ``cosim`` binds the native
C++ fixed-point engine ``native/fixsim.cpp``; ``golden`` writes the RTL
testbenches' golden vectors; ``arch_check`` holds the mini pair to the RTL
blueprint; ``proof`` measures the reconstruction in float and through the
integer datapath; ``cosim_report`` runs the integer-datapath suite;
``vcd`` parses the reference RTL's recorded waveforms and
``rtl_cycle_model`` models the as-built RTL cycle by cycle."""
