"""The port's modules: denoiser, sampler and codec."""
