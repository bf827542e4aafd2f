"""The port's training driver (``python -m repro_torch.launch.train``)
on the CPU: LM mode with checkpoints, a restart that resumes at the saved
step (the resumed run gives the uninterrupted run's losses and parameters
bit for bit), the production mesh refused outside a world of 256 ranks,
and ``--solver`` against the JAX package's ``run_solver`` (the same FISTA
steps, rounds, active and screened groups)."""
import contextlib
import io
import re
import signal

import pytest
import torch


@pytest.fixture(autouse=True)
def keep_sigterm_handler():
    """A checkpointed run installs the preemption hook on SIGTERM; the test
    process gets its own handler back afterwards."""
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)


def _train(tmp, steps, *extra):
    from repro_torch.launch.train import main

    return main(["--arch", "demo", "--steps", str(steps), "--batch", "2",
                 "--seq", "16", "--lr", "1e-3", "--sgl-lam", "3e-4",
                 "--ckpt-dir", str(tmp), "--ckpt-every", "2",
                 "--device", "cpu", *extra])


@pytest.fixture
def one_thread():
    """Multithreaded CPU training is not bit-reproducible run to run (the
    port's CPU ops split some reductions by thread); one thread is."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_launch_train_resumes_at_the_saved_step(tmp_path, one_thread):
    """An uninterrupted 4-step run against a 2-step run restarted for
    steps 2-3: the restart resumes at step 2 with the saved parameters and
    gives the same losses and final parameters, bit for bit."""
    full = _train(tmp_path / "a", 4)
    assert full["start"] == 0 and len(full["losses"]) == 4
    first = _train(tmp_path / "b", 2)
    assert first["losses"] == full["losses"][:2]
    rest = _train(tmp_path / "b", 4)
    assert rest["start"] == 2
    assert rest["losses"] == full["losses"][2:]
    a, b = full["params"].state_dict(), rest["params"].state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert full["ffn_zero"] is not None and full["n_params"] > 0


def test_launch_train_rejects_the_production_mesh_on_one_rank(tmp_path):
    """LM mode trains across ranks on the production mesh, which needs a
    world of 256: from one process (no torchrun world) it raises
    ``make_production_mesh``'s world-size message."""
    import torch.distributed as dist

    made = not dist.is_initialized()
    with pytest.raises(ValueError, match=r"needs a world of 256 ranks, "
                       r"got 1"):
        _train(tmp_path, 1, "--production-mesh")
    assert not (made and dist.is_initialized())   # no world was started


SOLVER_ARGS = ["--solver", "--n", "25", "--p", "80", "--groups", "10",
               "--tau", "0.2", "--tol", "0.1"]


def test_launch_train_solver_matches_reference():
    """Both packages' ``--solver`` on the n = 25, p = 80, 10-group f32
    problem.  tol 0.1: the f32 gap is rounded to multiples of 2^-10 here
    (||y||^2 = 3.0e4), so a tol near 1e-6 ends by chance (a gap rounded to
    0) or at max_epochs in either package; at 0.1 both stop where the gap
    crosses it, at the same step."""
    import sys

    from repro.launch import train as jtrain
    from repro_torch.launch.train import main

    argv = sys.argv
    sys.argv = ["train"] + SOLVER_ARGS
    try:
        jargs = jtrain.parse_args()
    finally:
        sys.argv = argv
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jtrain.run_solver(jargs)
    m = re.search(r"gap (\S+) in \S+ \((\d+) FISTA steps, (\d+) screen "
                  r"rounds\); active groups (\d+)/10; screened (\d+)",
                  out.getvalue())
    gap, steps, rounds, active, screened = m.groups()
    got = main(SOLVER_ARGS + ["--device", "cpu"])
    assert got["gap"] <= 0.1 and float(gap) <= 0.1
    assert (got["fista_steps"], got["rounds"], got["active"],
            got["screened"]) == (int(steps), int(rounds), int(active),
                                 int(screened))
