"""Tensor ops of the port: attention (K1-K3 and their plain versions),
the int8 matmuls (K4 and its plain version), ODE solvers, interpolation
and the inverse STFT."""
