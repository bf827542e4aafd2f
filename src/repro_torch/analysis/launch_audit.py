"""CUDA launch auditor: launch geometry against the H100's limits, and
the coverage of every output over the geometry's tile map.

Counterpart of ``repro/analysis/pallas_audit.py``.  Consumes the
:class:`repro_torch.kernels._util.LaunchSpec` objects the kernel wrappers
hand their launchers (registered in ``kernels/ops.py``), so the audited
geometry IS the launched geometry.  The limits are compute capability
9.0's, from :mod:`repro_torch.launch.roofline`.  The codes, and the Pallas
check each one replaces:

* **CU000** the spec builder raised (PL000).
* **CU001** the spec is over a hardware limit: more than 1,024 threads per
  block, a block dimension over (1024, 1024, 64), a grid dimension over
  (2^31 - 1, 65535, 65535), or an empty grid or block (new: a Pallas grid
  has no such limits).
* **CU002** an output element fewer blocks write than the output declares
  (one, unless it is a replicated write) — a coverage gap (PL002).
* **CU003** an output element more blocks write than the output declares,
  or a tile outside its output — an overlap (PL003, and PL001's
  out-of-bounds block).
* **CU004** more dynamic shared memory than a block may opt in to
  (232,448 B) or than one SM holds beside the 1 KB it keeps per block
  (233,472 B) (PL004's VMEM budget).
* **CU005** a bad cluster shape: more than 16 CTAs (the H100's
  non-portable maximum, which a launcher of more than 8 opts in to), or a
  cluster that does not divide the grid (new).
* **CU006** (info) the grid is too large to enumerate, so the coverage
  proof is skipped (PL006).
* **CU007** (on the card, ``cuda=True``) the built kernel disagrees with
  its spec — its launch bounds or registers allow fewer threads per block
  than the spec's, its static shared memory plus the spec's dynamic
  shared memory is over a block's limit — or no block (no cluster) of the
  spec fits on the card (new: a Pallas kernel is built by the compiler
  that launches it).

PL005 (a declared carried grid axis) has no twin: a CUDA grid has no
carried axes; a kernel's accumulation lives in its own loops (the BCD
epochs, corr's column chunks), and a tile map lists each chunk's pass as
an output of its own (``out+chunk<k>``).

Coverage is checked over the tile map of the geometry the wrapper sizes
its launch from and reads its launch arguments from (``spec.geometry.
tile_map``: block coordinates -> the element ranges of each output that
block writes).  That is a check of the geometry model, not of the kernel:
the tile map restates the CUDA indexing in Python, and nothing but review
and the card tests ties the two together.  An output may declare more than
one writer per element (:class:`~repro_torch.kernels._util.Output`): the
CTAs of a BCD cluster with beta in global memory all store the same
values; :func:`replicated_outputs` lists such outputs, and the payload
reports them.  A spec without a geometry is only checked against the
limits.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

from ..kernels._util import Output
from ..launch import roofline as hw
from .findings import Finding

__all__ = ["audit_built_kernel", "audit_launch_spec", "coverage_findings",
           "replicated_outputs", "run"]

MAX_POINTS = 200_000     # blocks enumerated for the coverage proof


def _prod(t) -> int:
    out = 1
    for v in t:
        out *= int(v)
    return out


def _finding(code: str, message: str, name: str, severity: str = "error",
             **details) -> Finding:
    return Finding(pass_name="launch", code=code, message=message,
                   severity=severity, location=name, details=details)


def _limits(spec, name: str) -> List[Finding]:
    out: List[Finding] = []
    grid, block = tuple(spec.grid), tuple(spec.block)
    threads = _prod(block)
    if len(grid) != 3 or len(block) != 3 or min(grid + block) < 1:
        out.append(_finding(
            "CU001", f"grid {grid} / block {block} must be three positive "
                     f"dimensions", name, grid=list(grid), block=list(block)))
        return out
    if threads > hw.MAX_THREADS_PER_BLOCK:
        out.append(_finding(
            "CU001", f"{threads} threads per block, over the limit of "
                     f"{hw.MAX_THREADS_PER_BLOCK}", name, threads=threads))
    for d, (b, lim) in enumerate(zip(block, hw.MAX_BLOCK_DIMS)):
        if b > lim:
            out.append(_finding(
                "CU001", f"block dimension {d} is {b}, over {lim}", name,
                dim=d, block=list(block)))
    for d, (g, lim) in enumerate(zip(grid, hw.MAX_GRID_DIMS)):
        if g > lim:
            out.append(_finding(
                "CU001", f"grid dimension {d} is {g}, over {lim}", name,
                dim=d, grid=list(grid)))
    smem = int(spec.smem_bytes)
    if smem > hw.SMEM_PER_BLOCK or smem + 1024 > hw.SMEM_PER_SM:
        out.append(_finding(
            "CU004", f"{smem} B of dynamic shared memory per block, over the "
                     f"{hw.SMEM_PER_BLOCK} B a block may opt in to",
            name, smem_bytes=smem, limit_bytes=hw.SMEM_PER_BLOCK))
    cluster = tuple(spec.cluster)
    C = _prod(cluster)
    if len(cluster) != 3 or min(cluster) < 1 or C > hw.MAX_CLUSTER:
        out.append(_finding(
            "CU005", f"cluster {cluster}: {C} CTAs, over the card's "
                     f"{hw.MAX_CLUSTER}", name, cluster=list(cluster)))
    elif any(g % c for g, c in zip(grid, cluster)):
        out.append(_finding(
            "CU005", f"cluster {cluster} does not divide grid {grid}", name,
            cluster=list(cluster), grid=list(grid)))
    return out


def _outputs(spec) -> List[Output]:
    return [Output(*o) for o in spec.outputs]


def coverage_findings(spec, name: str,
                      max_points: int = MAX_POINTS) -> List[Finding]:
    """CU002/CU003/CU006 over ``spec.tile_map``: every element of every
    declared output written by exactly as many blocks as the output
    declares (one, unless it is a replicated write)."""
    if spec.tile_map is None:
        return []
    grid = tuple(spec.grid)
    if _prod(grid) > max_points:
        return [_finding(
            "CU006", f"grid {grid} too large to enumerate (> {max_points} "
                     f"blocks); coverage proof skipped", name,
            severity="info")]
    outputs = {o.name: o for o in _outputs(spec)}
    tiles: Dict[str, List[Tuple[int, int, tuple]]] = {k: [] for k in outputs}
    out: List[Finding] = []
    outside = []
    for pt in itertools.product(*(range(g) for g in grid)):
        for t in spec.tile_map(*pt):
            if t.output not in outputs or not (
                    0 <= t.start <= t.stop <= outputs[t.output].elements):
                outside.append((pt, t))
            elif t.stop > t.start:
                tiles[t.output].append((t.start, t.stop, pt))
    if outside:
        pt, t = outside[0]
        extent = (outputs[t.output].elements if t.output in outputs
                  else "an undeclared output")
        out.append(_finding(
            "CU003", f"{len(outside)} tiles outside their output (first: "
                     f"block {pt} writes {t.output}[{t.start}:{t.stop}] of "
                     f"{extent})",
            name, n_outside=len(outside), block=list(pt)))
    for o in outputs.values():
        # Sweep the tiles' ends: between two ends the writers are constant.
        ends = sorted([(s, 1, pt) for s, _, pt in tiles[o.name]]
                      + [(e, -1, pt) for _, e, pt in tiles[o.name]]
                      + [(o.elements, 0, None)])
        active: List[tuple] = []
        pos = gaps = overlaps = 0
        first_gap: Optional[Tuple[int, int]] = None
        first_overlap = None
        for at, step, pt in ends:
            if at > pos:
                if len(active) < o.writers:
                    gaps += at - pos
                    first_gap = first_gap or (pos, at)
                elif len(active) > o.writers:
                    overlaps += at - pos
                    first_overlap = first_overlap or (pos, sorted(active))
                pos = at
            if step > 0:
                active.append(pt)
            elif step < 0:
                active.remove(pt)
        if gaps:
            out.append(_finding(
                "CU002", f"{o.name}: {gaps} of {o.elements} elements written "
                         f"by fewer than {o.writers} block(s) (first gap "
                         f"[{first_gap[0]}, {first_gap[1]})) — coverage gap",
                name, output=o.name, n_missing=gaps,
                first_gap=list(first_gap)))
        if overlaps:
            s, blocks = first_overlap
            out.append(_finding(
                "CU003", f"{o.name}: {overlaps} elements written by more "
                         f"than {o.writers} block(s) (first: element {s}, "
                         f"blocks {blocks})", name, output=o.name,
                n_overlap=overlaps))
    return out


def replicated_outputs(spec) -> Dict[str, int]:
    """The outputs of ``spec`` that more than one block writes, each with
    its number of writers."""
    return {o.name: o.writers for o in _outputs(spec) if o.writers > 1}


def audit_launch_spec(spec, *, name: str = "",
                      max_points: int = MAX_POINTS) -> List[Finding]:
    """The static checks of one spec: CU001, CU004, CU005, and the coverage
    proof (CU002, CU003, CU006)."""
    name = name or spec.name
    findings = _limits(spec, name)
    if not any(f.code == "CU001" for f in findings):
        findings += coverage_findings(spec, name, max_points)
    return findings


def audit_built_kernel(spec, *, name: str = "") -> Tuple[List[Finding], dict]:
    """CU007: the built kernel of ``spec`` against the spec, on the card.
    Returns the findings and what was read (attributes, and blocks per SM
    or clusters on the card)."""
    from ..faults.errors import KernelLaunchError
    from ..kernels._util import built_attributes, max_active

    name = name or spec.name
    try:
        attrs = built_attributes(spec)
        fits = max_active(spec)
    except KernelLaunchError as e:     # the query itself refused the spec
        return [_finding("CU007", f"the card refused the spec's query: {e}",
                         name)], {}
    threads = _prod(spec.block)
    read = dict(attrs, threads=threads, smem_bytes=int(spec.smem_bytes),
                cluster=_prod(spec.cluster),
                **{"clusters_on_card" if _prod(spec.cluster) > 1
                   else "blocks_per_sm": fits})
    findings: List[Finding] = []
    if attrs["max_threads_per_block"] < threads:
        findings.append(_finding(
            "CU007", f"the built kernel takes at most "
                     f"{attrs['max_threads_per_block']} threads per block "
                     f"({attrs['num_regs']} registers each), the spec "
                     f"launches {threads}", name, **read))
    if attrs["static_smem_bytes"] + spec.smem_bytes > hw.SMEM_PER_BLOCK:
        findings.append(_finding(
            "CU007", f"static {attrs['static_smem_bytes']} B + dynamic "
                     f"{spec.smem_bytes} B of shared memory, over "
                     f"{hw.SMEM_PER_BLOCK} B per block", name, **read))
    if fits < 1:
        unit = "cluster" if _prod(spec.cluster) > 1 else "block"
        findings.append(_finding(
            "CU007", f"no {unit} of this launch fits on the card "
                     f"(occupancy 0)", name, **read))
    return findings, read


def run(audits=None, *, cuda: bool = False,
        built: Optional[Dict[str, dict]] = None,
        replicated: Optional[Dict[str, dict]] = None) -> List[Finding]:
    """Audit every registered kernel launch spec (or the given mapping).
    With ``cuda=True`` also CU007 against the built kernels (on the card);
    ``built``, when given, receives what was read per spec, and
    ``replicated`` each spec's :func:`replicated_outputs`, where it has
    any."""
    if audits is None:
        from ..kernels import ops  # noqa: F401  (registers the builders)
        from .registry import kernel_audits

        audits = kernel_audits()
    findings: List[Finding] = []
    for name, builder in sorted(audits.items()):
        try:
            spec = builder()
        except Exception as e:
            findings.append(_finding(
                "CU000", f"launch-spec builder failed: "
                         f"{type(e).__name__}: {e}", name))
            continue
        findings.extend(audit_launch_spec(spec, name=name))
        if replicated is not None and replicated_outputs(spec):
            replicated[name] = replicated_outputs(spec)
        if cuda:
            got, read = audit_built_kernel(spec, name=name)
            findings.extend(got)
            if built is not None:
                built[name] = read
    return findings
