"""Hand-written CUDA kernels of the port (Hopper, sm_90a, f64) with their
plain PyTorch versions; :mod:`repro_torch.kernels.ops` holds the wrappers
the solver calls."""
