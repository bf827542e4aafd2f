"""Carry the reference package's state into the port and results back out.

The port imports nothing of ``repro``: state crosses as numpy arrays.
:func:`problem_from_reference` takes the fields of a reference
``SGLProblem`` as numpy arrays and builds the port's problem with exactly
those values (no power iteration is rerun, so a test can hold the solver
apart from ``_group_spectral_norms``); a binarized ``y`` in ``arrays`` gives
the logistic problem.  :func:`loss_from_reference` and
:func:`rule_from_reference` map a reference loss or rule (by name, or an
object with the same ``name`` and fields) to the port's.

LM parameters (:func:`lm_params_from_reference`,
:func:`lm_params_to_reference`): the reference keeps a dict tree with its
scanned layer stacks as one leading axis and projections as (in, out)
matrices; the port keeps per-layer modules with ``nn.Linear`` (out, in)
weights and depthwise ``nn.Conv1d`` (C, 1, W) convolutions.  The mapping
walks the reference structure that :func:`repro_torch.models.build`'s
``param_specs`` gives.  Caches have the reference's layout (stacked by
layer) in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from .core.precision import DTYPE
from .core.session import PathResult
from .core.sgl import SGLProblem
from .kernels._util import resolve_device
from .losses import Loss, get_loss
from .rules import ScreeningRule, get_rule

__all__ = ["beta_from_reference", "lm_params_from_reference",
           "lm_params_to_reference", "lm_reference_structs",
           "loss_from_reference", "path_result_to_numpy",
           "problem_from_reference", "rule_from_reference"]

_FLOAT_FIELDS = ("X", "y", "w", "Lg", "Xnorm_col", "Xnorm_grp")


def problem_from_reference(arrays: Dict[str, np.ndarray], device=None,
                           dtype: torch.dtype = DTYPE) -> SGLProblem:
    """``arrays``: the reference problem's X, y, w, tau, feat_mask, Lg,
    Xnorm_col and Xnorm_grp as numpy arrays (e.g.
    ``{f: np.asarray(getattr(p, f)) for f in p._fields}``).  ``dtype``: f64
    unless named (the mesh strategy also takes an f32 problem, as the
    reference's does)."""
    dev = resolve_device(device)
    fields = {f: torch.tensor(np.asarray(arrays[f]), dtype=dtype).to(dev)
              for f in _FLOAT_FIELDS}
    fields["feat_mask"] = torch.tensor(
        np.asarray(arrays["feat_mask"], bool)).to(dev)
    fields["tau"] = float(np.asarray(arrays["tau"]))
    return SGLProblem(**fields)


def beta_from_reference(beta, device=None) -> torch.Tensor:
    """A reference (G, ng) coefficient array as a warm start for the port."""
    return torch.tensor(np.asarray(beta), dtype=DTYPE).to(
        resolve_device(device))


def path_result_to_numpy(res: PathResult) -> Dict[str, np.ndarray]:
    """The array fields of a :class:`PathResult` plus its scalar counters,
    as numpy values (the per-lambda ``results`` list is left out)."""
    return {f: np.asarray(getattr(res, f)) for f in res._fields
            if f != "results"}


def loss_from_reference(loss) -> Loss:
    """The port's registered loss of the same name as ``loss`` (a name or a
    reference loss object)."""
    return get_loss(loss if isinstance(loss, str) else loss.name)


def rule_from_reference(rule, **fields) -> ScreeningRule:
    """The port's rule of the same name as ``rule`` (a name or a reference
    rule object), with the reference object's dataclass fields (e.g. the
    strong rule's ``shrink``) and then ``fields`` applied."""
    if isinstance(rule, str):
        name = rule
    else:
        name = rule.name
        fields = {**dataclasses.asdict(rule), **fields}
    port = get_rule(name)
    return dataclasses.replace(port, **fields) if fields else port


# ---------------------------------------------------------------------------
# LM parameters and caches
# ---------------------------------------------------------------------------

# Reference leaves that are projections x @ W with W (in, out): the port's
# nn.Linear weight is W^T (an MoE expert stack (E, in, out) -> (E, out, in)).
_LINEAR = frozenset({"wq", "wk", "wv", "wo", "w1", "w2", "w3", "in_proj",
                     "out_proj", "proj_x", "proj_gate", "w_a", "w_x",
                     "proj_out", "unembed"})
_BIAS = {"bq": "wq", "bk": "wk", "bv": "wv"}
_STACKS = {"layers": "n_layers", "enc_layers": "n_enc_layers",
           "dec_layers": "n_layers"}


def _port_leaf(keys: Tuple[str, ...]) -> Tuple[str, str]:
    """(port state-dict name, transform) of the reference leaf at ``keys``
    (layer indices as digits): transform "T" swaps the last two axes,
    "conv" maps (W, C) to (C, 1, W), "" keeps the array."""
    *parent, leaf = keys
    if leaf in _BIAS:
        return ".".join(parent + [_BIAS[leaf], "bias"]), ""
    if leaf == "conv_w":
        return ".".join(parent + ["conv", "weight"]), "conv"
    if leaf == "conv_b":
        return ".".join(parent + ["conv", "bias"]), ""
    if leaf in _LINEAR:
        if parent and parent[-1] == "moe":
            return ".".join(keys), "T"
        return ".".join(list(keys) + ["weight"]), "T"
    return ".".join(keys), ""


def _spec_leaves(tree, path=()) -> Iterator[Tuple[str, ...]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, path + (str(i),))
    else:
        yield path


def _reference_leaves(cfg) -> Iterator[Tuple[Tuple[str, ...], int]]:
    """(reference path, layer count of its stack or 0) of every leaf of the
    reference parameter tree of ``cfg``."""
    from .models import build

    for path in _spec_leaves(build(cfg).param_specs()):
        stacked = (path[0] in _STACKS and len(path) > 1
                   and not path[1].isdigit())
        yield path, getattr(cfg, _STACKS[path[0]]) if stacked else 0


def _get(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def _to_port(a: np.ndarray, how: str) -> np.ndarray:
    if how == "T":
        return np.swapaxes(a, -1, -2)
    if how == "conv":
        return a.T[:, None, :]
    return a


def _to_reference(a: np.ndarray, how: str) -> np.ndarray:
    if how == "T":
        return np.swapaxes(a, -1, -2)
    if how == "conv":
        return a[:, 0, :].T
    return a


def lm_params_from_reference(cfg, tree) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree of ``cfg`` (numpy-convertible leaves)
    as the port model's state dict, CPU tensors of the leaves' dtypes
    (``model.load_state_dict(...)``)."""
    out = {}
    for path, n_stack in _reference_leaves(cfg):
        arr = np.asarray(_get(tree, path))
        if n_stack:
            for i in range(n_stack):
                name, how = _port_leaf((path[0], str(i)) + path[1:])
                out[name] = torch.tensor(
                    np.ascontiguousarray(_to_port(arr[i], how)))
        else:
            name, how = _port_leaf(path)
            out[name] = torch.tensor(
                np.ascontiguousarray(_to_port(arr, how)))
    return out


def _reference_tree(cfg, state_dict, leaf, stack) -> dict:
    """The reference's parameter tree of ``cfg`` from the port's state dict:
    ``leaf(tensor, transform)`` converts one port leaf, ``stack`` joins a
    layer stack's leaves."""
    tree: dict = {}
    for path, n_stack in _reference_leaves(cfg):
        if n_stack:
            arr = stack([leaf(state_dict[name], how)
                         for name, how in (
                             _port_leaf((path[0], str(i)) + path[1:])
                             for i in range(n_stack))])
        else:
            name, how = _port_leaf(path)
            arr = leaf(state_dict[name], how)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    if "layers" in tree and any(k.isdigit() for k in tree["layers"]):
        tree["layers"] = [tree["layers"][str(i)]
                          for i in range(len(tree["layers"]))]
    return tree


def lm_params_to_reference(cfg, state_dict) -> dict:
    """The port's state dict (or model) of ``cfg`` as the reference's
    parameter tree of numpy arrays (stacked layers, (in, out) matrices)."""
    if isinstance(state_dict, torch.nn.Module):
        state_dict = state_dict.state_dict()
    host = lambda t: t.detach().cpu().float().numpy() \
        if t.dtype == torch.bfloat16 else t.detach().cpu().numpy()
    return _reference_tree(cfg, state_dict,
                           lambda t, how: _to_reference(host(t), how),
                           np.stack)


def _reference_view(t: torch.Tensor, how: str) -> torch.Tensor:
    if how == "T":
        return t.transpose(-1, -2)
    if how == "conv":
        return t[:, 0, :].T
    return t


def lm_reference_structs(cfg, state_dict) -> dict:
    """The port's state dict (or model) of ``cfg``, or a tree keyed like it
    (an optimizer moment), in the reference's tree layout as tensors:
    views, and stacks of a layer stack's leaves.  On meta tensors nothing
    is allocated; the dry run pairs the result with ``param_specs``."""
    if isinstance(state_dict, torch.nn.Module):
        state_dict = state_dict.state_dict()
    return _reference_tree(cfg, state_dict, _reference_view, torch.stack)
