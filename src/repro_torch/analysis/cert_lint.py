"""Certificate-safety dataflow lints (AST pass over ``src/repro_torch``).

Counterpart of ``repro/analysis/cert_lint.py``, with the same codes.  The
safety bit is the product: a ``RoundResult.safe`` / ``PathResult.
certificates_safe`` of True is a *proof claim* (the masks are certified
zeros at the optimum).  These lints make the claim unforgeable at the
source level:

* **CS001** every ``RoundResult(...)`` / ``PathResult(...)`` construction
  must thread ``safe=`` / ``certificates_safe=`` explicitly from rule
  metadata — never a bare ``True`` literal (outside ``rules/library.py``),
  never by omission (the NamedTuple default would silently claim safety).
  ``safe`` is the port's ``RoundResult`` field 5 (``core/solver.py``).
  Re-wraps that forward an existing result (``RoundResult(*r)``) are
  exempt: the bit travels through the star.
* **CS002** no module under ``core/`` or ``kernels/`` names the unsafe
  ``StrongSequentialRule`` — the solver must only ever see the abstract
  :class:`repro_torch.rules.ScreeningRule` protocol, so an unsafe rule
  cannot be special-cased into a trusted path.
* **CS003** every rule registered with ``is_safe=True`` is exercised by
  the safety-matrix tests in ``tests/test_torch_rules.py`` (the tests that
  check a path's screens against a tight-tol unscreened solve) — a rule
  claiming safety that no test cross-checks is an unbacked proof claim.
* **CS004** no ``except`` handler under ``core/`` or ``serve/``
  constructs a ``RoundResult``/``PathResult`` or adopts a screen mask
  (``group_active &= ...`` / ``feat_active &= ...``): an exception means
  the round's dataflow is suspect, and the only sound moves are to
  rewind to known-good state or re-raise — never to synthesise a result.
"""
from __future__ import annotations

import ast
import os
from typing import List, Optional, Sequence

from .findings import Finding

__all__ = ["run"]

MATRIX_FILE = "test_torch_rules.py"

_RESULT_KEYS = {
    "RoundResult": ("safe", 5),          # (keyword, positional index)
    "PathResult": ("certificates_safe", None),
}


def _py_files(root: str, subdirs: Optional[Sequence[str]] = None):
    for dirpath, _dirnames, filenames in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        if subdirs is not None:
            if rel == "." or not any(
                    rel == s or rel.startswith(s + os.sep) for s in subdirs):
                continue
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def _callee_name(func) -> str:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


def _is_true_literal(node) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def lint_result_constructions(
    src_root: str,
    allow_literal_files: Sequence[str] = ("rules/library.py",),
) -> List[Finding]:
    findings: List[Finding] = []
    allow = {os.path.normpath(p) for p in allow_literal_files}
    for path in _py_files(src_root):
        rel = os.path.normpath(os.path.relpath(path, src_root))
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        allowed = rel in allow
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = _callee_name(node.func)
            if name not in _RESULT_KEYS:
                continue
            key, pos = _RESULT_KEYS[name]
            loc = f"{rel}:{node.lineno}"
            if any(isinstance(a, ast.Starred) for a in node.args):
                continue   # re-wrap: the bit travels through the star
            kw = next((k for k in node.keywords if k.arg == key), None)
            if kw is not None:
                if _is_true_literal(kw.value) and not allowed:
                    findings.append(Finding(
                        pass_name="cert", code="CS001",
                        message=(f"{name}({key}=True) hard-codes the "
                                 f"safety claim; thread it from the "
                                 f"rule's is_safe metadata"),
                        location=loc,
                    ))
                continue
            if pos is not None and len(node.args) > pos:
                if _is_true_literal(node.args[pos]) and not allowed:
                    findings.append(Finding(
                        pass_name="cert", code="CS001",
                        message=(f"{name}(...) passes a literal True in "
                                 f"the {key} position"),
                        location=loc,
                    ))
                continue
            if any(k.arg is None for k in node.keywords):
                continue   # **kwargs forward — bit travels through it
            findings.append(Finding(
                pass_name="cert", code="CS001",
                message=(f"{name}(...) omits {key}= and silently claims "
                         f"safety through the field default"),
                location=loc,
            ))
    return findings


def lint_strong_imports(src_root: str) -> List[Finding]:
    findings: List[Finding] = []
    for path in _py_files(src_root, subdirs=("core", "kernels")):
        rel = os.path.normpath(os.path.relpath(path, src_root))
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            hit = None
            if isinstance(node, ast.ImportFrom):
                if any(a.name == "StrongSequentialRule"
                       for a in node.names):
                    hit = "imports"
            elif isinstance(node, (ast.Name, ast.Attribute)):
                ident = (node.id if isinstance(node, ast.Name)
                         else node.attr)
                if ident == "StrongSequentialRule":
                    hit = "references"
            if hit:
                findings.append(Finding(
                    pass_name="cert", code="CS002",
                    message=(f"solver-layer module {hit} the unsafe "
                             f"StrongSequentialRule directly; unsafe "
                             f"rules must stay behind the ScreeningRule "
                             f"protocol"),
                    location=f"{rel}:{node.lineno}",
                ))
    return findings


_MASK_NAMES = {"group_active", "feat_active"}


def lint_exception_paths(
    src_root: str,
    subdirs: Sequence[str] = ("core", "serve"),
) -> List[Finding]:
    """CS004: exception handlers in solver/serve code must rewind or
    re-raise — never construct a result object or adopt a screen mask.

    Re-wraps through a star (``RoundResult(*r)``) are exempt for the
    same reason as CS001: the safety bit travels through an existing,
    already-certified result rather than being synthesised in the
    handler.
    """
    findings: List[Finding] = []
    for path in _py_files(src_root, subdirs=subdirs):
        rel = os.path.normpath(os.path.relpath(path, src_root))
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    name = _callee_name(sub.func)
                    if name not in _RESULT_KEYS:
                        continue
                    if any(isinstance(a, ast.Starred) for a in sub.args):
                        continue
                    findings.append(Finding(
                        pass_name="cert", code="CS004",
                        message=(f"except handler constructs {name}(...); "
                                 f"exception paths must rewind or "
                                 f"re-raise, never synthesise a result"),
                        location=f"{rel}:{sub.lineno}",
                    ))
                elif (isinstance(sub, ast.AugAssign)
                      and isinstance(sub.op, ast.BitAnd)):
                    tgt = sub.target
                    ident = (tgt.id if isinstance(tgt, ast.Name)
                             else tgt.attr if isinstance(tgt, ast.Attribute)
                             else "")
                    if ident in _MASK_NAMES:
                        findings.append(Finding(
                            pass_name="cert", code="CS004",
                            message=(f"except handler intersects screen "
                                     f"mask {ident!r}; a mask narrowed on "
                                     f"an exception path is an uncertified "
                                     f"discard"),
                            location=f"{rel}:{sub.lineno}",
                        ))
    return findings


def lint_safety_matrix(tests_root: str, safe_rule_names: Sequence[str],
                       filename: str = MATRIX_FILE) -> List[Finding]:
    path = os.path.join(tests_root, filename)
    where = f"tests/{filename}"
    if not os.path.exists(path):
        return [Finding(
            pass_name="cert", code="CS003",
            message=f"{where} (safety-matrix tests) not found",
            location=path,
        )]
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    covered: set = set()
    n_matrix = 0
    for node in ast.walk(tree):
        if (isinstance(node, ast.FunctionDef)
                and "matrix" in node.name):
            n_matrix += 1
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Constant)
                        and isinstance(sub.value, str)):
                    covered.add(sub.value)
    findings: List[Finding] = []
    if n_matrix == 0:
        findings.append(Finding(
            pass_name="cert", code="CS003",
            message=f"no safety-matrix test function (name containing "
                    f"'matrix') found in {where}",
            location=where,
        ))
        return findings
    for name in safe_rule_names:
        if name not in covered:
            findings.append(Finding(
                pass_name="cert", code="CS003",
                message=(f"rule {name!r} is registered is_safe=True but "
                         f"is not exercised by the safety-matrix tests"),
                location=where,
                details={"covered": sorted(covered)},
            ))
    return findings


def _default_roots():
    here = os.path.dirname(os.path.abspath(__file__))   # .../src/repro_torch/analysis
    src_root = os.path.dirname(here)                    # .../src/repro_torch
    repo = os.path.dirname(os.path.dirname(src_root))       # repo root
    return src_root, os.path.join(repo, "tests")


def run(src_root: Optional[str] = None,
        tests_root: Optional[str] = None,
        safe_rule_names: Optional[Sequence[str]] = None) -> List[Finding]:
    d_src, d_tests = _default_roots()
    src_root = src_root or d_src
    tests_root = tests_root or d_tests
    if safe_rule_names is None:
        from ..rules import available_rules, get_rule

        safe_rule_names = [n for n in available_rules()
                           if get_rule(n).is_safe]
    findings = lint_result_constructions(src_root)
    findings += lint_strong_imports(src_root)
    findings += lint_exception_paths(src_root)
    findings += lint_safety_matrix(tests_root, safe_rule_names)
    return findings
