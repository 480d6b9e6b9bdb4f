"""Tensor ops of the port: attention (K1 and its plain version), ODE
solvers, interpolation and the inverse STFT."""
