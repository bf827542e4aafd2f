"""The NCEP/NCAR climate regression of Ndiaye et al. (2016), Sec. 7.1.

``make_climate_like`` below is a verbatim frozen copy of the construction
in ``repro_torch/data/climate.py`` (a stand-in with the reanalysis's
structure: the real data cannot be fetched here), kept here so that the
benchmark's inputs do not move when the program's generator does.
:func:`make` builds a configuration's problem from its ``data_seed`` on the
host and applies the run's ``--seed`` (:func:`bench.lib.seeded.reorder`).
"""
from __future__ import annotations

import numpy as np

from bench.lib.seeded import reorder

__all__ = ["make", "make_climate_like"]

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


def make(cfg: dict, seed: int) -> dict:
    """The configuration's design and response (float64, host), rows
    permuted and columns signed by ``seed``."""
    X, y, _, _ = make_climate_like(
        n=cfg["n_samples"], n_lon=cfg["n_lon"], n_lat=cfg["n_lat"],
        n_vars=cfg["n_vars"], n_active_regions=cfg["n_active_regions"],
        noise=cfg["noise"], seed=cfg["data_seed"])
    X, y = reorder(X, y, seed)
    return {"X": X, "y": y, "ng": cfg["n_vars"]}
