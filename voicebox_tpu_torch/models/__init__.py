"""The port's modules: denoiser, sampler, duration predictor and codec."""
