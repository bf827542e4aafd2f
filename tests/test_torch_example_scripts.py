"""The reference's ``examples/climate_path.py`` and the port's
``examples/climate_path_torch.py --device cpu``, each run as a script in a
subprocess (both at once), print the same lines once the seconds and the
speed-up are masked: per rule the total epochs, GAP's sequential screens,
zero-epoch lambdas, gathers, certified rounds and transposed copies, and
the Figure 4 support map.

The reference runs with the Pallas solver backend as its ``"auto"`` (the
backend it picks on its own platform, in interpret mode here), since it
batches lambdas only on that backend and the port batches on both of its
own (see ``tests/test_torch_examples.py``); the script itself is run
unchanged.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SCRIPT_S = 600
# Runs a reference script with the Pallas solver backend as "auto".
_REF_RUNNER = (
    "import runpy, sys\n"
    "import repro.core.session as s\n"
    "auto = s.resolve_solver_backend\n"
    "s.resolve_solver_backend = lambda b: auto('pallas' if b == 'auto' "
    "else b)\n"
    "runpy.run_path(sys.argv[1], run_name='__main__')\n")


def _masked(text):
    text = re.sub(r"path time +[0-9.]+s", "path time <s>", text)
    return re.sub(r"no screening: [0-9.]+x", "no screening: <x>", text)


def test_climate_scripts_print_the_same_lines():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               JAX_ENABLE_X64="1", OMP_NUM_THREADS="1")
    examples = ROOT / "examples"
    procs = {
        "reference": subprocess.Popen(
            [sys.executable, "-c", _REF_RUNNER,
             str(examples / "climate_path.py")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True),
        "port": subprocess.Popen(
            [sys.executable, str(examples / "climate_path_torch.py"),
             "--device", "cpu"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True),
    }
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=SCRIPT_S)
            assert proc.returncode == 0, (name, stderr[-2000:])
            out[name] = _masked(stdout).splitlines()
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert out["port"] == out["reference"]
    assert any(line.startswith("rule=none ") for line in out["port"])
    assert out["port"][-1].startswith("active grid points: ")
