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
    ROOT / "tools" / "path_ab_torch.py",
    ROOT / "tools" / "mesh_step_cost_torch.py",
    ROOT / "tools" / "profile_lm_torch.py",
    ROOT / "examples" / "quickstart_torch.py",
    ROOT / "examples" / "serve_lm_torch.py",
    ROOT / "examples" / "train_lm_sgl_torch.py"]


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
        "import repro_torch.serve, repro_torch.ckpt, repro_torch.faults\n"
        "import repro_torch.core.elastic, repro_torch.core.path\n"
        "import repro_torch.distributed, repro_torch.launch.mesh\n"
        "import repro_torch.faults.chaos, repro_torch.faults.__main__\n"
        "import repro_torch.analysis, repro_torch.analysis.registry\n"
        "import repro_torch.analysis.cert_lint, repro_torch.analysis.main\n"
        "import repro_torch.analysis.launch_audit\n"
        "import repro_torch.analysis.dispatch_lints\n"
        "import repro_torch.analysis.entrypoints\n"
        "import repro_torch.analysis.__main__\n"
        "import repro_torch.launch.report, repro_torch.launch.reanalyze\n"
        "import repro_torch.configs, repro_torch.configs.sgl_paper\n"
        "import repro_torch.models, repro_torch.models.ssm\n"
        "import repro_torch.models.rglru, repro_torch.models.encdec\n"
        "import repro_torch.train, repro_torch.launch.train\n"
        "import repro_torch.launch.specs, repro_torch.launch.dryrun\n"
        "assert repro_torch.configs.get('sgl-paper').n_groups == 262_144\n"
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
    PORT / "distributed" / "solver_dist.py", PORT / "launch" / "mesh.py",
    PORT / "launch" / "train.py", PORT / "train" / "sgl_regularizer.py",
    PORT / "train" / "train_step.py",
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


def test_server_without_device_raises_without_gpu():
    _no_cuda()
    from repro_torch.serve import ServeConfig, SessionCache, SGLServer

    with pytest.raises(RuntimeError, match="CUDA"):
        SGLServer(ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        SessionCache()
    # With an explicit CPU device it is built (and never started here).
    assert SGLServer(ServeConfig(device="cpu")).device.type == "cpu"


def test_make_test_mesh_without_device_raises_without_gpu():
    _no_cuda()
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    with pytest.raises(RuntimeError, match="CUDA"):
        make_test_mesh()
    # Nothing was initialised on the way to the error.
    assert not dist.is_initialized() or dist.get_backend() == "gloo"


def test_chaos_matrix_without_device_raises_without_gpu():
    _no_cuda()
    from repro_torch.faults.__main__ import main
    from repro_torch.faults.chaos import run_matrix

    with pytest.raises(RuntimeError, match="CUDA"):
        run_matrix(verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--check"])


def test_analysis_gate_without_device_raises_without_gpu():
    _no_cuda()
    from repro_torch.analysis.__main__ import main
    from repro_torch.analysis.entrypoints import default_entry_specs
    from repro_torch.analysis.main import run_checks

    with pytest.raises(RuntimeError, match="CUDA"):
        run_checks()
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--check"])
    with pytest.raises(RuntimeError, match="CUDA"):
        default_entry_specs()


def test_elastic_without_device_raises_without_gpu():
    _no_cuda()
    from repro_torch.core import elastic_objective, make_elastic_problem

    X, y, sizes = np.eye(4, 6), np.ones(4), [3, 3]
    with pytest.raises(RuntimeError, match="CUDA"):
        make_elastic_problem(X, y, sizes, tau=0.5, lam2=1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        elastic_objective(X, y, np.ones(6), 0.5, [1.0, 1.0], 0.1, 1.0, sizes)
    # A tensor keeps its device; a named device is used.
    got = elastic_objective(torch.as_tensor(X), y, np.ones(6), 0.5,
                            [1.0, 1.0], 0.1, 1.0, sizes)
    assert got.device.type == "cpu"
    assert elastic_objective(X, y, np.ones(6), 0.5, [1.0, 1.0], 0.1, 1.0,
                             sizes, device="cpu").device.type == "cpu"


def test_lm_entry_points_without_device_raise_without_gpu():
    _no_cuda()
    from repro_torch.configs.base import DEMO
    from repro_torch.models import build

    api = build(DEMO)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_params()
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_cache(2, 8)
    # With an explicit CPU device the model is built there.
    assert api.init_params(device="cpu").embed.device.type == "cpu"


def test_launch_train_without_device_raises_without_gpu():
    _no_cuda()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for extra in ([], ["--solver"]):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--steps",
             "1", *extra], env=env, capture_output=True, text=True,
            timeout=120)
        assert out.returncode != 0, out.stdout
        assert "no CUDA device is available" in out.stderr


def test_configs_registry_keeps_the_reference_messages():
    from repro_torch.configs import ARCH_IDS, get, list_archs

    assert list_archs() == ARCH_IDS == ["sgl-paper", "demo"]
    with pytest.raises(KeyError, match="repro_torch.configs.base"):
        get("llama3-405b")
    with pytest.raises(KeyError, match="unknown arch 'gpt-5'"):
        get("gpt-5")


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
