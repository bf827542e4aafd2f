"""The chaos matrix of the port (``repro_torch.faults.chaos``, ``python -m
repro_torch.faults``) on the CPU, against the JAX package's.

Each of the 16 scenarios is one case: it must pass with no unsafe
certificate and no hung future.  The 14 scenarios the two packages share
must also give the reference's outcome fields (``ok``, ``fired``,
``nonfinite_rounds``, ``quarantined``, ``retries``, ``worker_restarts``,
``poison_drops``) under the same plans.  The reference's two demotion
scenarios are the port's two typed-error scenarios: the injected raise
leaves the session as ``KernelLaunchError``, ``kernel_demotions`` stays 0.
The sessions run on the CPU, so the "cuda" backends run the kernels'
plain versions.
"""
import functools
import json

import pytest

from repro.faults import chaos as jchaos
from repro_torch.faults import KernelLaunchError, chaos
from repro_torch.faults.__main__ import main

DEV = "cpu"
FIELDS = ("ok", "fired", "nonfinite_rounds", "quarantined", "retries",
          "worker_restarts", "poison_drops")
RENAMED = {"screen_kernel_raise_typed_error": "screen_kernel_raise_demotes",
           "epoch_kernel_raise_typed_error": "epoch_kernel_raise_demotes"}
NAMES = [name for name, _fn in chaos.SCENARIOS]


@functools.lru_cache(maxsize=None)
def _ctx():
    import torch

    return chaos._Ctx(0, torch.device(DEV))


@functools.lru_cache(maxsize=None)
def _reference():
    report = jchaos.run_matrix(seed=0, verbose=False)
    return {s["name"]: s for s in report["scenarios"]}


def test_scenario_names_are_the_references_with_two_renamed():
    ref = [name for name, _fn in jchaos.SCENARIOS]
    assert len(NAMES) == len(ref) == 16
    assert [RENAMED.get(n, n) for n in NAMES] == ref


@pytest.mark.parametrize("name", NAMES)
def test_chaos_scenario(name):
    fn = dict(chaos.SCENARIOS)[name]
    out = fn(_ctx())
    assert out["ok"], out["detail"]
    assert out.get("unsafe", 0) == 0
    assert out.get("hung", 0) == 0
    if name in RENAMED:
        assert out["kernel_demotions"] == 0
        assert out["fired"] == 1
        assert "KernelLaunchError" in out["detail"]
        return
    ref = _reference()[name]
    for f in FIELDS:
        assert bool(out.get(f) == ref.get(f)), (f, out.get(f), ref.get(f))


def test_typed_error_leaves_the_session_as_kernel_launch_error():
    """The screening site's injected raise is the exception the caller
    gets: the port retries nothing on a plain version."""
    ctx = _ctx()
    res, sess, log = chaos._solve_under(
        ctx, chaos.FaultPlan((chaos.FaultSpec("kernels.screen", "raise",
                                              hits=(0,)),)),
        screen_backend="cuda")
    assert isinstance(res, KernelLaunchError)
    assert log.count() == 1
    assert sess.kernel_demotions == 0 and sess.backend == "cuda"


def test_cli_list(capsys):
    assert main(["--list"]) == 0
    assert capsys.readouterr().out.split() == NAMES


def test_cli_check_passes_and_writes_the_report(tmp_path, capsys):
    path = tmp_path / "chaos.json"
    path.write_text(json.dumps({"serve_faults": {"kept": 1}}))
    fast = ["nan_storm_typed_error", "ckpt_truncate_quarantine",
            "ckpt_bitflip_quarantine"]
    assert main(["--check", "--device", DEV, "--json", str(path),
                 "--only", *fast]) == 0
    data = json.loads(path.read_text())
    assert data["serve_faults"] == {"kept": 1}          # merged, not clobbered
    report = data["chaos"]
    assert report["ok"] and report["failures"] == 0
    assert report["unsafe_certificates"] == 0 and report["hung_futures"] == 0
    assert report["recovery"]["kernel_demotions_total"] == 0
    assert report["seed"] == 0 and report["device"] == "cpu"
    assert [s["name"] for s in report["scenarios"]] == fast
    assert report["seconds"] >= 0
    assert "3 scenarios on cpu, 0 failures" in capsys.readouterr().out


def test_cli_check_fails_on_a_failing_scenario(monkeypatch):
    broken = [(n, (lambda ctx: {"ok": False, "detail": "broken"})
               if n == "ckpt_truncate_quarantine" else f)
              for n, f in chaos.SCENARIOS]
    monkeypatch.setattr(chaos, "SCENARIOS", broken)
    assert main(["--check", "--device", DEV, "--only",
                 "ckpt_truncate_quarantine"]) == 1
    with pytest.raises(SystemExit):
        main(["--only", "no_such_scenario"])
