"""The wide BCD kernel's algorithm and its selection, on the CPU.

``csrc/bcd_wide.cu`` splits each cyclic BCD epoch into the movers' chain
(the groups with beta_g != 0 at the epoch's start, in order, a snapshot of
the residual after each), every other live group's gradient against the
snapshot its position gives it, and a redo from the first group that
leaves 0.  :func:`wide_epochs` below restates those three steps in plain
PyTorch, the kernel's passes of at most ``cap`` movers included, and is
held against the serial sweep (``ref.bcd_epochs_ref``).  The kernel itself
is held against the same sweep on the card (``tests/test_torch_gpu.py``).

Tolerance 1e-12 (rtol and atol): the two compute each gradient in another
order of f64 sums, on O(1) inputs.
"""
import bisect
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import launch_audit
from repro_torch.core import SGLSession, SolverConfig, make_problem
from repro_torch.data import make_synthetic
from repro_torch.kernels import _util, ops, ref
from repro_torch.kernels import bcd_wide as kw
from repro_torch.kernels.bcd_epoch import bcd_epoch_work
from repro_torch.launch.roofline import SMEM_PER_BLOCK

TOL = dict(rtol=1e-12, atol=1e-12)
ROOT = Path(__file__).resolve().parents[1]


def _prox(Xt, Lg, w, fmask, g, bold, r, tau, lam):
    """Group g's update from beta_g = bold against the residual r."""
    L = Lg[g]
    z = (bold + Xt[g].T @ r / L) * fmask[g]
    z = torch.sign(z) * torch.clamp(z.abs() - tau * lam / L, min=0.0)
    nrm = torch.linalg.vector_norm(z)
    t2 = (1.0 - tau) * w[g] * lam / L
    return torch.clamp(1.0 - t2 / torch.clamp(nrm, min=1e-30), min=0.0) * z


def wide_epochs(Xt, Lg, w, fmask, beta, r, tau, lam, n_epochs, cap):
    """Steps 1-3 of ``csrc/bcd_wide.cu`` for one lambda: (beta, r, epochs
    with a redo, entrants found, exits)."""
    beta, r = beta.clone(), r.clone()
    live = Lg > 0
    Gl = int(torch.nonzero(live).max()) + 1 if live.any() else 0
    M = [g for g in range(Gl) if live[g] and bool((beta[g] != 0).any())]
    redo = entrants = exits = 0
    for e in range(n_epochs):
        if e:
            kept = [m for m in M if bool((beta[m] != 0).any())]
            exits += len(M) - len(kept)
            M = kept
        start = i0 = 0
        redo_e = 0
        while start < Gl:
            k = min(cap, len(M) - i0)
            movers = M[i0:i0 + k]
            stop = M[i0 + k] if i0 + k < len(M) else Gl
            # 1. the movers in order, a snapshot of r after each
            snaps, olds = [r.clone()], []
            for m in movers:
                bold = beta[m].clone()
                olds.append(bold)
                nb = _prox(Xt, Lg, w, fmask, m, bold, r, tau, lam)
                d = bold - nb
                if bool((d != 0).any()):
                    beta[m] = nb
                    r = r + Xt[m] @ d
                snaps.append(r.clone())
            # 2. every other live group against its segment's snapshot
            found = [g for g in range(start, stop)
                     if live[g] and g not in movers
                     and bool((_prox(Xt, Lg, w, fmask, g,
                                     torch.zeros_like(beta[g]),
                                     snaps[bisect.bisect_left(movers, g)],
                                     tau, lam) != 0).any())]
            # 3. commit, or redo from the first entrant
            if not found:
                start, i0 = stop, i0 + k
                continue
            E = min(found)
            j = bisect.bisect_left(movers, E)
            for i in range(j, k):
                beta[movers[i]] = olds[i]
            r = snaps[j]
            M.insert(i0 + j, E)
            i0, start, redo_e = i0 + j, E, 1
            entrants += 1
        redo += redo_e
    return beta, r, redo, entrants, exits


def _problem(seed, Gb=40, n=30, ng=4, inert=3, warm=8):
    rng = np.random.default_rng(seed)
    Xt = rng.standard_normal((Gb, n, ng))
    Lg = np.einsum("gnk,gnk->g", Xt, Xt)
    Lg[-inert:] = 0.0                                  # padding at the tail
    Lg[Gb // 3] = 0.0                                  # and one inside
    fmask = (rng.random((Gb, ng)) > 0.2).astype(np.float64)
    fmask[5] = 0.0                                     # a masked-out group
    beta = np.zeros((Gb, ng))
    on = rng.choice(Gb - inert, warm, replace=False)
    beta[on] = rng.standard_normal((warm, ng))         # some of them exit
    y = rng.standard_normal(n)
    lam_max = np.abs(np.einsum("gnk,n->gk", Xt, y)).max()
    r = y - np.einsum("gnk,gk->n", Xt, beta)
    t = torch.as_tensor
    return (t(Xt), t(Lg), t(np.sqrt(ng) * np.ones(Gb)), t(fmask), t(beta),
            t(r), lam_max)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("cap", [2, 128])
@pytest.mark.parametrize("frac", [0.15, 0.4])
def test_wide_steps_equal_the_serial_sweep(seed, cap, frac):
    """Movers, then the others in parallel, then commit or redo: equal to
    cyclic BCD within 1e-12, with passes of 2 movers and of 128."""
    Xt, Lg, w, fmask, beta, r, lam_max = _problem(seed)
    tau, lam, E = 0.3, frac * lam_max, 4
    got_b, got_r, *_ = wide_epochs(Xt, Lg, w, fmask, beta, r, tau, lam, E,
                                   cap)
    want_b, want_r = ref.bcd_epochs_ref(
        Xt, Lg, w, fmask[None], beta[None], r[None], tau,
        torch.tensor([lam], dtype=torch.float64), E)
    torch.testing.assert_close(got_b, want_b[0], **TOL)
    torch.testing.assert_close(got_r, want_r[0], **TOL)
    inert = Lg <= 0
    assert torch.equal(got_b[inert], beta[inert])


def test_the_problems_have_entrants_exits_and_redos():
    """The cases above do what they are for: groups enter (each a redo),
    warm groups leave 0, and a cold start is all redos."""
    tally = np.zeros(3, int)
    for seed in range(6):
        Xt, Lg, w, fmask, beta, r, lam_max = _problem(seed)
        tally += wide_epochs(Xt, Lg, w, fmask, beta, r, 0.3,
                             0.15 * lam_max, 4, 2)[2:]
    redo, entrants, exits = tally
    assert redo > 0 and entrants >= redo and exits > 0
    Xt, Lg, w, fmask, beta, r, lam_max = _problem(0, warm=0)
    b, _, redo, entrants, _ = wide_epochs(Xt, Lg, w, fmask, beta, r, 0.3,
                                          0.2 * lam_max, 1, 128)
    assert redo == 1 and entrants == int((b != 0).any(-1).sum()) > 1


def test_a_still_buffer_is_one_pass():
    """Above lambda_max nothing moves: no redo, beta and r unchanged."""
    Xt, Lg, w, fmask, beta, r, lam_max = _problem(1, warm=0)
    b, rr, redo, entrants, exits = wide_epochs(Xt, Lg, w, fmask, beta, r,
                                               0.3, 1.5 * lam_max, 3, 128)
    assert redo == entrants == exits == 0
    assert torch.equal(b, beta) and torch.equal(rr, r)


# ---------------------------------------------------------------------------
# Selection, geometry and registration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Gb,n,ng,loss,want", [
    (1, 16_384, 814, 7, "lsq", True),           # the climate full width
    (1, kw.WIDE_MIN_GROUPS, 814, 7, "lsq", True),
    (1, kw.WIDE_MIN_GROUPS - 1, 814, 7, "lsq", False),
    (1, 128, 100, 10, "lsq", True),             # the synthetic buffers
    (1, 32, 814, 7, "lsq", False),              # a compact climate buffer
    (4, 16_384, 814, 7, "lsq", False),          # batched lambdas
    (1, 16_384, 814, 7, "logistic", False),
    (1, 16_384, 814, 32, "lsq", False),         # two slices do not fit
    (1, 16_384, 100, 33, "lsq", False),
    (1, 4096, 2000, 4, "lsq", True),
    (1, 4096, 3000, 4, "lsq", False),          # its residual buffers too
])
def test_the_wide_kernel_is_chosen_by_shape(B, Gb, n, ng, loss, want):
    assert kw.bcd_wide_selected(B, Gb, n, ng, loss) is want


def test_wide_geometry_fits_a_block_and_passes_the_audit():
    spec = kw.bcd_wide_launch_spec(16_384, 814, 7)
    geo = spec.geometry
    assert spec.name == "bcd_wide" and spec.block == (288, 1, 1)
    assert spec.grid == (132, 1, 1) and spec.cluster == (1, 1, 1)
    assert geo.stages == 4 and geo.smem_bytes <= SMEM_PER_BLOCK
    # Two more stages would not fit: the ring is as deep as memory allows.
    assert kw._smem_bytes(814, 7, geo.stages + 1) > SMEM_PER_BLOCK
    assert geo.flag_bytes < geo.scratch_bytes
    assert launch_audit.audit_launch_spec(spec) == []
    assert launch_audit.replicated_outputs(spec) == {}
    assert "bcd_wide/climate" in ops._AUDITS
    with pytest.raises(ValueError, match="ring stages"):
        kw.bcd_wide_geometry(16_384, 814, 32)


def test_meta_branch_names_the_kernel_the_shape_takes():
    """The dry run counts the wide kernel where the card would launch it,
    with the same work model as the cluster kernel's."""
    f64 = dict(dtype=torch.float64, device="meta")
    e = torch.empty

    def call(B, Gb, n, ng):
        with _util.meta_count() as work:
            ops.bcd_epochs_fused(e((Gb, n, ng), **f64), e((Gb,), **f64),
                                 e((Gb,), **f64), e((B, Gb, ng), **f64),
                                 e((B, Gb, ng), **f64), e((B, n), **f64),
                                 0.4, e((B,), **f64), 10)
        return work

    wide = call(1, 16_384, 814, 7)
    assert wide.launches == {"bcd_wide": 1}
    flops, nbytes = bcd_epoch_work(1, 16_384, 814, 7, 10)
    assert (wide.flops, wide.bytes) == (flops, nbytes)
    assert call(4, 16_384, 814, 7).launches == {"bcd_epoch": 1}
    assert call(1, 32, 100, 10).launches == {"bcd_epoch": 1}


def test_a_cpu_path_counts_no_wide_epoch():
    """On the CPU the plain versions run: no wide epoch, no redo."""
    X, y, _, sizes = make_synthetic(n=25, p=80, n_groups=10, seed=0)
    prob = make_problem(X, y, sizes, tau=0.3, device="cpu")
    res = SGLSession(prob, SolverConfig(tol=1e-8, rule="none",
                                        solver_backend="cuda",
                                        screen_backend="cuda"),
                     device="cpu").solve_path(T=4, delta=1.0)
    assert res.bcd_wide_epochs == res.bcd_wide_redo_epochs == 0


def _metric():
    path = ROOT / "bench" / "metrics" / "bcd_spec_hit_pct.py"
    spec = importlib.util.spec_from_file_location("bcd_spec_hit_pct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Run:
    def __init__(self, paths):
        self.paths = paths


class _Path:
    def __init__(self, wide=None, redo=None):
        if wide is not None:
            self.bcd_wide_epochs, self.bcd_wide_redo_epochs = wide, redo


def test_spec_hit_metric_reads_the_median_share_without_redo():
    read = _metric().read
    assert read(_Run([_Path(100, 3), _Path(100, 5), _Path(200, 0)])) == \
        pytest.approx(97.0)
    assert read(_Run([_Path(0, 0)])) is None           # no wide epoch
    assert read(_Run([_Path()])) is None               # a program without it
