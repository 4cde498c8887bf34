"""Layout converters, parameter files and the JAX weight bridge."""
