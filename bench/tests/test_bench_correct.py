"""What decides ``correct``, shown to fail where it must, on the CPU at a
size a test run holds: the float32 control in the program's place, and a
run with the timed path broken underneath (the program's state left
unchanged by a step, half of the samples left out of the epochs, an
answer altered where the path produces it)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench import control
from bench import run as bench_run

SEED = 2**31 + 7
CELLS = ("climate_gap", "synthetic_gap", "climate_none")


@pytest.mark.parametrize("cell", CELLS)
def test_float32_control_fails_and_its_float64_twin_passes(tiny_root, cell):
    low = control.run_control(cell, SEED, device="cpu", root=tiny_root)
    assert not low["passes"]
    assert low["checks"]["gap_over_tol"] > 10.0
    twin = control.run_control(cell, SEED, device="cpu", root=tiny_root,
                               dtype=torch.float64)
    assert twin["passes"], twin


def _unchanged_state(ops, monkeypatch):
    def epochs(Xt, Lg, w, fmask, beta, carry, *args, **kwargs):
        return beta, carry
    monkeypatch.setattr(ops, "bcd_epochs_fused", epochs)


def _half_of_the_samples(ops, monkeypatch):
    orig = ops.bcd_epochs_fused

    def epochs(Xt, Lg, w, fmask, beta, carry, *args, **kwargs):
        keep = Xt.clone()
        keep[:, Xt.shape[1] // 2:, :] = 0.0
        part = carry.clone()
        part[:, carry.shape[1] // 2:] = 0.0
        return orig(keep, Lg, w, fmask, beta, part, *args, **kwargs)
    monkeypatch.setattr(ops, "bcd_epochs_fused", epochs)


def _altered(field):
    def patch(ops, monkeypatch):
        from repro_torch.core import SGLSession

        orig = SGLSession.solve_path

        def solve_path(self, *args, **kwargs):
            res = orig(self, *args, **kwargs)
            if len(res.lambdas) < 3:            # the warm-up
                return res
            t = len(res.lambdas) - 1
            if field == "beta":
                betas = res.betas.copy()
                g = int(np.argmin(np.abs(betas[t]).sum(axis=1)))
                betas[t, g, 0] += 1e-3
                return res._replace(betas=betas)
            if field == "gap":
                return res._replace(gaps=res.gaps * 0.5)
            g_act = res.group_active.copy()
            g = int(np.argmax(np.abs(res.betas[t]).sum(axis=1)))
            g_act[t, g] = False
            return res._replace(group_active=g_act)
        monkeypatch.setattr(SGLSession, "solve_path", solve_path)
    return patch


FAULTS = {
    "state_unchanged": _unchanged_state,
    "half_of_the_samples": _half_of_the_samples,
    "beta_altered": _altered("beta"),
    "gap_altered": _altered("gap"),
    "mask_altered": _altered("mask"),
}


def test_a_sound_run_is_correct(tiny_root):
    line = bench_run.run_cell("climate_gap", SEED, 0.1, False,
                              device="cpu", root=tiny_root)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"path_s.host_paced", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_path_is_not_correct(tiny_root, monkeypatch, fault):
    import repro_torch.core  # noqa: F401  (the x64 posture first)
    from repro_torch.kernels import ops

    FAULTS[fault](ops, monkeypatch)
    line = bench_run.run_cell("climate_gap", SEED, 0.1, False,
                              device="cpu", root=tiny_root)
    assert line["correct"] is False
    assert line["failed"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_cell_on_the_card(tiny_root, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    line = bench_run.run_cell(cell, SEED, 0.1, True, device="cuda",
                              root=tiny_root)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    bcd = [v["value"] for k, v in line["metrics"].items()
           if k.split(".")[0] == "bcd_roofline"]
    assert len(bcd) == 1 and 0 < bcd[0] <= 100
