"""Hand-written CUDA kernels of the port (Hopper, sm_90a; f64, and f32 for
``sgl_prox``) with their plain PyTorch versions; :mod:`repro_torch.kernels.ops` holds the wrappers
the solver calls."""
