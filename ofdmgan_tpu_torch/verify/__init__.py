"""Verification against independent engines: ``cosim`` binds the native
C++ fixed-point engine ``native/fixsim.cpp``."""
