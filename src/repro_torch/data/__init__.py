"""Data generators of the port: numpy-only copies of ``repro.data``'s, so the
port needs nothing of the reference package."""
from .synthetic import make_synthetic
from .climate import make_climate_like

__all__ = ["make_synthetic", "make_climate_like"]
