"""Multi-pod dry run: count every (architecture x input shape) cell on the
production meshes and derive memory / cost / collective statistics, with no
compiler, no card and no real ranks.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch demo --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch sgl-paper --shape solve

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell on 512 forced host devices and reads the compiled HLO.  Here each cell
runs on meta tensors (shapes only: nothing is computed or allocated) over a
fake process group of 256 ranks (512 with ``--multi-pod``,
``torch.testing._internal.distributed.fake_pg``), on which
:func:`repro_torch.launch.mesh.make_production_mesh` lays out this process
as one rank of the (16, 16) or (2, 16, 16) mesh; every collective returns
at once.  :func:`repro_torch.launch.roofline.count_step` counts one call of
the step: FLOPs, bytes, the collectives' bytes by kind, and the kernel
launches (the wrappers' meta branches, with their work models).  Those raw
counts go into each cell's JSON (``counts``), where the reference keeps the
``.hlo.gz``; :func:`repro_torch.launch.reanalyze.reanalyze_cell` rebuilds
the roofline from them.

* The sgl-paper cell counts one rank's shard of the distributed FISTA step
  (f32 and bf16 designs), the batched-lambda step (B = 256, bf16 design)
  and a screening round, per rank; totals are per-rank counts x chips, as
  the reference scales its per-device costs.
* An LM cell counts one rank's share of the step, as the sharded trainer
  runs it (:func:`repro_torch.launch.specs.build_cell`): the rank's rows
  of the global batch, the parameters gathered whole from their DTensor
  shards, and for ``train`` the gradient all-reduce and AdamW on the
  rank's shards.  Its FLOPs, bytes and ``collectives`` are per rank, the
  roofline's totals per-rank counts x chips; ``split`` records the rows a
  rank computes and how many ranks repeat them, and
  ``reference_collectives`` the reference's per-device bytes of the same
  cell (XLA's partitioned program, which moves activations: a different
  split, recorded beside this one, not repaired).
* ``memory.argument_bytes`` is each rank's shard of the arguments, from
  their shapes and logical specs; a ``decode`` cell's cache is counted as
  the rank holds it (its rows, whole along heads; ``cache_bytes``), beside
  the reference's model-axis split of it (``cache_bytes_reference``).
  ``temp_bytes``, ``peak_bytes`` (and ``output_bytes``) are null: no
  meta-device figure gives them, where the reference reads
  ``compiled.memory_analysis()``.

``--all`` runs each cell in a subprocess (so a failing cell cannot wedge
the sweep), with the reference's per-cell timeout and error JSONs; where
the reference runs one at a time (each compile holds gigabytes), a cell
here holds ~300 MB, so the sweep runs as many at once as the host has
cores, less two.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

import torch

__all__ = ["REFERENCE_COLLECTIVES", "fake_world", "main", "run_cell",
           "sweep"]

META = torch.device("meta")
# The reference's per-device collective bytes of demo's LM cells, from its
# own dry run on the CPU (``python -m repro.launch.dryrun --arch demo
# --shape <shape> [--multi-pod]``): XLA split the model's attention and FFN
# activations across the model axis.
REFERENCE_COLLECTIVES = {
    ("demo", "train_4k", False): {
        "all-reduce": 1_468_796_804, "all-gather": 1_300_889_344,
        "reduce-scatter": 0, "all-to-all": 285_212_672,
        "collective-permute": 679_739_648},
    ("demo", "prefill_32k", False): {
        "all-reduce": 301_992_064, "all-gather": 318_771_200,
        "reduce-scatter": 0, "all-to-all": 117_440_512,
        "collective-permute": 150_995_200},
    ("demo", "decode_32k", False): {
        "all-reduce": 2_107_520, "all-gather": 79_716_992,
        "reduce-scatter": 0, "all-to-all": 2_816,
        "collective-permute": 1_504},
    ("demo", "train_4k", True): {
        "all-reduce": 1_845_891_044, "all-gather": 789_167_616,
        "reduce-scatter": 0, "all-to-all": 251_658_240,
        "collective-permute": 931_135_744},
    ("demo", "prefill_32k", True): {
        "all-reduce": 436_209_792, "all-gather": 142_610_688,
        "reduce-scatter": 0, "all-to-all": 109_051_904,
        "collective-permute": 234_881_152},
    ("demo", "decode_32k", True): {
        "all-reduce": 1_052_736, "all-gather": 39_872_672,
        "reduce-scatter": 0, "all-to-all": 1_408,
        "collective-permute": 752},
}
MEMORY_NOTE = (
    "argument_bytes: each rank's shard, from the arguments' shapes and "
    "logical specs (a decode cell's cache as the rank holds it); output, "
    "temp and peak bytes: no meta-device figure gives them")


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake default process group of ``world_size`` ranks (this process
    is rank 0) for the dry run's meta tensors, made only when no group
    exists and destroyed on exit, also on error.  Where a group exists it
    is left alone, and :func:`make_production_mesh` checks its size."""
    import torch.distributed as dist

    if dist.is_initialized():
        yield
        return
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this "
            "torch does not have; it never falls back to a real group") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nbytes(tree) -> int:
    from torch.utils._pytree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _shard_bytes(specs, structs, mesh, multi_pod: bool) -> int:
    """Bytes of one rank's shard of ``structs`` laid out by the logical
    ``specs`` on ``mesh`` (specs the mesh cannot divide are replicated, as
    ``shardings_for_structs`` sanitizes them)."""
    from .mesh import P, _sizes, map_specs, sanitize_spec, translate_spec

    sizes = _sizes(mesh)
    total = []

    def leaf(spec, t):
        s = sanitize_spec(translate_spec(spec, multi_pod=multi_pod),
                          tuple(t.shape), sizes)
        shards = 1
        for entry in s:
            if entry is None or entry is P.UNCONSTRAINED:
                continue
            for a in (entry if isinstance(entry, (tuple, list)) else
                      (entry,)):
                shards *= sizes[a]
        total.append(t.numel() * t.element_size() // shards)
        return spec

    map_specs(leaf, specs, structs)
    return sum(total)


def run_cell(arch: str, shape_name: str, multi_pod: bool, q_chunk: int = 512,
             json_out=None, quiet=False):
    from .mesh import make_production_mesh

    with fake_world(512 if multi_pod else 256):
        result = _count_cell(arch, shape_name, multi_pod, q_chunk,
                             make_production_mesh(multi_pod=multi_pod,
                                                  device=META))
    _emit(result, json_out, quiet)
    return result


def _count_cell(arch, shape_name, multi_pod, q_chunk, mesh):
    from ..configs import get
    from ..configs.base import SHAPES_BY_NAME, shape_applicable
    from . import mesh as meshlib
    from . import roofline as rl

    t0 = time.time()
    chips = mesh.size()
    if arch == "sgl-paper":
        return _run_sgl_cell(mesh, multi_pod, chips)
    cfg = get(arch)
    shape = SHAPES_BY_NAME[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": reason}

    from . import specs as speclib

    cell = speclib.build_cell(cfg, shape, mesh=mesh, multi_pod=multi_pod,
                              q_chunk=q_chunk)
    counts = rl.count_step(cell.fn, *cell.args)
    # model flops: tokens processed this step
    if cell.kind in ("train", "prefill"):
        tokens = shape.global_batch * shape.seq_len
    else:
        tokens = shape.global_batch  # one token per sequence
    p_structs = cell.args[0].module
    mf = rl.model_flops(cfg, p_structs, cell.kind, tokens)
    # The count is one rank's: the totals are per-rank counts x chips.
    roof = rl.Roofline(flops=counts["flops"] * chips,
                       bytes_accessed=counts["bytes_accessed"] * chips,
                       collective_bytes=counts["collective_bytes"] * chips,
                       chips=chips, model_flops=mf, dtype="bfloat16")
    memory = {
        "argument_bytes": _shard_bytes(cell.in_specs, cell.structs, mesh,
                                       multi_pod),
        "output_bytes": None,
        "temp_bytes": None,
        "peak_bytes": None,
    }
    if cell.kind == "decode":
        # the cache as the rank holds it, beside the reference's split
        held = _nbytes(cell.args[1])
        split = _shard_bytes(cell.in_specs[1], cell.structs[1], mesh,
                             multi_pod)
        memory["argument_bytes"] += held - split
        memory.update(cache_bytes=held, cache_bytes_reference=split)
    ref = REFERENCE_COLLECTIVES.get((arch, shape_name, multi_pod))
    return {
        "arch": arch,
        "shape": shape_name,
        "multi_pod": multi_pod,
        "status": "ok",
        "kind": cell.kind,
        "chips": chips,
        "seconds": time.time() - t0,
        "params": rl.count_params(p_structs),
        "active_params": rl.active_params(cfg, p_structs),
        "split": {"batch_axes": list(cell.split.axes),
                  "rows_per_rank": cell.split.rows,
                  "repeat": cell.split.repeat},
        "memory": memory,
        "memory_note": MEMORY_NOTE,
        "collectives": {k[len("coll_"):]: v for k, v in counts.items()
                        if k.startswith("coll_")},
        "reference_collectives": (None if ref is None else
                                  {k: float(v) for k, v in ref.items()}),
        "roofline": roof.as_dict(),
        "counts": counts,
        "counts_per": "rank",
    }


def _run_sgl_cell(mesh, multi_pod, chips):
    """The paper's own workload on the production mesh: one rank's shard of
    one distributed FISTA step and one screening round, on meta tensors.

    The batched-lambda step runs B = 256 path points per pass over a bf16
    design.  Its iterate state is f32: the reference passes a bf16 state,
    but its prox and update promote the iterate to f32 after one step (so
    does the port's), and the sgl_prox kernel takes f32 or f64.  The
    screening round stays f32 (its certificate needs it)."""
    from ..configs import get
    from ..distributed.solver_dist import make_dist_step
    from . import mesh as meshlib
    from . import roofline as rl

    cfg = get("sgl-paper")
    n, G, ng = cfg.n_samples, cfg.n_groups, cfg.group_size
    n_l, G_l = n // meshlib.dp_size(mesh), G // meshlib.model_size(mesh)
    B = 256
    f32, bf16 = torch.float32, torch.bfloat16

    def meta(shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=META)

    X, Xh = meta((n_l, G_l, ng)), meta((n_l, G_l, ng), bf16)
    y, gv, sv = meta((n_l,)), meta((G_l, ng)), meta((G_l,))
    bv, scB = meta((B, G_l, ng)), meta((B,))
    # The step takes t, lam_ and L (and the screen's lam_, ynorm2) as host
    # floats: their values do not change a count.
    t, lam_, L, ynorm2 = 1.0, 1.0, 1.0, 1.0
    k32 = make_dist_step(mesh, tau=cfg.tau, multi_pod=multi_pod, dtype=f32)
    k16 = make_dist_step(mesh, tau=cfg.tau, multi_pod=multi_pod, dtype=bf16)
    calls = (
        ("fista", k32.fista, (X, y, gv, gv, gv, sv, t, lam_, L)),
        ("fista_bf16", k16.fista, (Xh, y, gv, gv, gv, sv, t, lam_, L)),
        (f"fista_batch{B}_bf16", k16.fista_batch,
         (Xh, y, bv, bv, bv, sv, scB, scB, L)),
        ("screen", k32.screen, (X, y, gv, gv, sv, gv, sv, lam_, ynorm2)),
    )
    out = {"arch": "sgl-paper", "shape": f"fista+screen n={n} G={G} ng={ng}",
           "multi_pod": multi_pod, "status": "ok", "chips": chips,
           "lambda_batch": B}
    for name, fn, args in calls:
        counts = rl.count_step(fn, *args)
        # useful flops: 2 matvecs over the active design matrix = 4*n*p
        # (x B for the batched-lambda step — B path points per X pass)
        mf = 4.0 * n * G * ng * (B if "batch" in name else 1)
        roof = rl.Roofline(
            flops=counts["flops"] * chips,
            bytes_accessed=counts["bytes_accessed"] * chips,
            collective_bytes=counts["collective_bytes"] * chips,
            chips=chips,
            model_flops=mf,
            dtype="float32",
        )
        out[name] = {
            "collectives": {k[len("coll_"):]: v for k, v in counts.items()
                            if k.startswith("coll_")},
            "roofline": roof.as_dict(),
            "memory": {"argument_bytes": _nbytes(args), "temp_bytes": None},
            "counts": counts,
            "counts_per": "rank",
        }
    out["memory_note"] = MEMORY_NOTE
    return out


def _write_json(path: str, payload: dict) -> None:
    """Write ``payload`` to ``path`` whole: into a temporary file beside it,
    renamed over it, so a reader that sees the file sees all of it."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2)
    os.replace(tmp, path)


def _emit(result, json_out, quiet):
    if json_out:
        _write_json(json_out, result)
    if not quiet:
        print(json.dumps(result, indent=2))


def _cell_shapes(arch: str, shapes=None):
    from ..configs.base import LM_SHAPES

    if arch == "sgl-paper":
        return ["solve"]
    return shapes or [s.name for s in LM_SHAPES]


def _cell_error(proc, err_file, arch, shape, mp, timeout, timed_out):
    if timed_out:
        return {"arch": arch, "shape": shape, "multi_pod": mp,
                "status": "timeout", "timeout_s": timeout}
    err_file.seek(0)
    return {"arch": arch, "shape": shape, "multi_pod": mp, "status": "error",
            "stderr": err_file.read().decode(errors="replace")[-4000:]}


def sweep(out_dir: str, multi_pod_values=(False, True), timeout: int = 3600,
          archs=None, shapes=None):
    """Run every cell in a subprocess, as many at once as the host has
    cores less two; write one JSON per cell (an error or timeout JSON for a
    cell that fails).  Returns [(tag, ok)] in the order the cells end."""
    import tempfile

    from ..configs import list_archs

    os.makedirs(out_dir, exist_ok=True)
    archs = archs or list(list_archs())
    pending = []
    for arch in archs:
        for shape in _cell_shapes(arch, shapes):
            for mp in multi_pod_values:
                tag = f"{arch}_{shape}_{'multi' if mp else 'single'}"
                out_json = os.path.join(out_dir, tag + ".json")
                if os.path.exists(out_json):
                    print(f"[skip existing] {tag}")
                    continue
                cmd = [
                    sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape,
                    "--json-out", out_json, "--quiet",
                ]
                if mp:
                    cmd.append("--multi-pod")
                pending.append((tag, arch, shape, mp, out_json, cmd))
    jobs = max(1, (os.cpu_count() or 1) - 2)
    results = {}
    running = []
    while pending or running:
        while pending and len(running) < jobs:
            tag, arch, shape, mp, out_json, cmd = pending.pop(0)
            print(f"[{time.strftime('%H:%M:%S')}] {tag} ...", flush=True)
            err = tempfile.TemporaryFile()
            proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                    stderr=err)
            running.append((proc, err, time.time(), tag, arch, shape, mp,
                            out_json))
        time.sleep(0.2)
        for item in list(running):
            proc, err, t0, tag, arch, shape, mp, out_json = item
            timed_out = proc.poll() is None and time.time() - t0 > timeout
            if timed_out:
                proc.kill()
                proc.wait()
            elif proc.returncode is None:
                continue
            running.remove(item)
            ok = proc.returncode == 0
            if not ok:
                _write_json(out_json, _cell_error(proc, err, arch, shape, mp,
                                                  timeout, timed_out))
            err.close()
            results[tag] = ok
            print(f"    {tag} -> {'ok' if ok else 'FAIL'} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    return list(results.items())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--json-out")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--q-chunk", type=int, default=512)
    ap.add_argument("--archs", nargs="*")
    args = ap.parse_args()

    if args.all:
        results = sweep(args.out, timeout=args.timeout, archs=args.archs)
        sys.exit(0 if all(ok for _, ok in results) else 1)

    try:
        run_cell(args.arch, args.shape, args.multi_pod,
                 q_chunk=args.q_chunk, json_out=args.json_out,
                 quiet=args.quiet)
    except Exception:
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
