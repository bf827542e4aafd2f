"""The port stands alone: no module of ``src/repro_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, the package imports with
JAX blocked, entry points refuse to fall back to the CPU, and no kernel
wrapper or solver driver catches a failed launch."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch_path.py",
    ROOT / "tools" / "lambda_cost_torch.py",
    ROOT / "tools" / "bcd_step_cost_torch.py",
    ROOT / "tools" / "dual_norm_scale_probe.py",
    ROOT / "tools" / "small_kernels_torch.py",
    ROOT / "examples" / "quickstart_torch.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_jax_nor_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch.core, repro_torch.kernels.ops, repro_torch.convert\n"
        "import repro_torch.data, repro_torch.rules, repro_torch.losses\n"
        "import repro_torch.obs, repro_torch.obs.check, repro_torch.obs.timing\n"
        "import repro_torch.obs.export, repro_torch.launch.roofline\n"
        "import repro_torch.analysis.findings, repro_torch.kernels.sgl_prox\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_LAUNCH_SITES = [PORT / "kernels" / f for f in
                 ("ops.py", "screening_scores.py", "dual_norm.py",
                  "bcd_epoch.py", "bcd_epoch_logistic.py", "sgl_prox.py",
                  "_build.py")] + [
    PORT / "core" / "solver.py", PORT / "core" / "session.py",
    PORT / "obs" / "timing.py", PORT / "obs" / "check.py",
    ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _LAUNCH_SITES, ids=lambda p: p.name)
def test_no_try_around_builds_or_launches(path):
    """A failed build or launch raises: no handler turns it into a quiet
    switch to the plain path (``try``/``finally`` cleanup is allowed)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    assert not any(isinstance(n, ast.Try) and n.handlers
                   for n in ast.walk(tree)), path


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")


def test_make_problem_without_device_raises_without_gpu():
    _no_cuda()
    from repro_torch.core import make_problem

    X = np.ones((4, 6))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_problem(X, np.ones(4), [3, 3], tau=0.5)


def test_session_without_device_raises_without_gpu():
    _no_cuda()
    from repro_torch.core import SGLSession, SolverConfig, make_problem

    prob = make_problem(np.eye(4, 6), np.ones(4), [3, 3], tau=0.5,
                        device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        SGLSession(prob, SolverConfig())
    # With an explicit CPU device it runs.
    assert SGLSession(prob, SolverConfig(), device="cpu").backend == "torch"


def _run_smoke(cwd: Path, script: Path):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_gpu():
    _no_cuda()
    out = _run_smoke(ROOT, ROOT / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    out = _run_smoke(tmp_path, script)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_backend_knobs_are_validated():
    from repro_torch.core import SolverConfig

    with pytest.raises(ValueError, match="auto|torch|cuda"):
        SolverConfig(screen_backend="pallas")
    SolverConfig(loss="logistic")          # registered: accepted
    with pytest.raises(ValueError,
                       match=r"registered losses: \['logistic', 'lsq', "
                             r"'multitask'\]"):
        SolverConfig(loss="huber")


def test_precision_posture_switches_tf32_off():
    import repro_torch.core  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_default_dtype() == torch.float32   # never changed
