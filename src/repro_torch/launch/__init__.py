"""Launch tooling of the port: the measured roofline term
(:mod:`repro_torch.launch.roofline`)."""
