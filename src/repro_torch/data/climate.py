"""Dimension-faithful stand-in for the NCEP/NCAR Reanalysis 1 experiment.

The paper's real dataset (monthly climate measurements, 1948-2015, 144x73
grid, 7 variables per grid point => X in R^{814 x 73577}, y = air temperature
near Dakar) is not redistributable offline.  This generator reproduces its
*structure*: n monthly samples, G grid-point groups of 7 physical variables
with strong within-group correlation, smooth spatial correlation across
neighbouring grid points, seasonality + trend (then removed, as the paper's
preprocessing does), and a target driven by a small set of nearby groups.
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_climate_like"]

VARIABLES = (
    "air_temperature", "precipitable_water", "relative_humidity",
    "pressure", "sea_level_pressure", "horizontal_wind", "vertical_wind",
)


def make_climate_like(
    n: int = 814,
    n_lon: int = 24,
    n_lat: int = 12,
    n_vars: int = 7,
    n_active_regions: int = 6,
    noise: float = 0.05,
    seed: int = 0,
    dtype=np.float64,
):
    """Returns (X, y, beta_true, group_sizes).

    Full-scale paper dims are n_lon=144, n_lat=73 (p = 73577 including the
    target stub); defaults here are reduced for CPU tests, but any size works
    (the benchmark uses larger grids).
    """
    rng = np.random.default_rng(seed)
    G = n_lon * n_lat
    p = G * n_vars
    t = np.arange(n)

    # Latent smooth climate fields: low-rank spatial factors * AR(1) drivers.
    k = 12
    drivers = np.empty((n, k))
    drivers[0] = rng.standard_normal(k)
    for i in range(1, n):
        drivers[i] = 0.8 * drivers[i - 1] + 0.6 * rng.standard_normal(k)

    lon = np.arange(n_lon)[:, None] / n_lon
    lat = np.arange(n_lat)[None, :] / n_lat
    loadings = np.stack(
        [
            np.cos(2 * np.pi * ((i + 1) * lon + (i % 3) * lat)).ravel()
            * np.exp(-(((lon - (i % 5) / 5.0) ** 2 + (lat - (i % 3) / 3.0) ** 2))
                     * 4.0).ravel()
            for i in range(k)
        ],
        axis=1,
    )  # (G, k)

    field = drivers @ loadings.T  # (n, G)
    season = np.sin(2 * np.pi * t / 12.0)[:, None]
    trend = (t / n)[:, None]

    X = np.empty((n, p))
    for v in range(n_vars):
        var_mix = field * (0.7 + 0.3 * rng.random(G)[None, :])
        X[:, v::n_vars] = (
            var_mix
            + 0.8 * season * (1.0 + 0.2 * v)
            + 0.5 * trend
            + 0.3 * rng.standard_normal((n, G))
        )

    # Paper preprocessing: remove seasonality and trend, then standardise.
    month = t % 12
    for m in range(12):
        X[month == m] -= X[month == m].mean(axis=0, keepdims=True)
    X -= np.outer(t - t.mean(), (X * (t - t.mean())[:, None]).sum(0)
                  / ((t - t.mean()) ** 2).sum())
    X /= np.maximum(X.std(axis=0, keepdims=True), 1e-12)

    # Target: sparse group-structured ground truth near a "Dakar" location.
    beta = np.zeros(p)
    target_g = rng.choice(G, size=n_active_regions, replace=False)
    for g in target_g:
        vs = rng.choice(n_vars, size=3, replace=False)
        beta[g * n_vars + vs] = rng.uniform(0.5, 2.0, size=3) * np.sign(
            rng.uniform(-1, 1, size=3)
        )
    y = X @ beta + noise * rng.standard_normal(n)
    y -= y.mean()
    return X.astype(dtype), y.astype(dtype), beta.astype(dtype), [n_vars] * G
