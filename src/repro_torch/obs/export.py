"""The one percentile implementation and the BENCH JSON schema.

Counterpart of ``repro/obs/export.py``:

* :func:`percentile` — linear interpolation (``numpy.percentile``'s default
  method) in pure Python, so the obs leaf stays import-cheap.
  ``Histogram.summary``, ``Tracer.percentiles`` and the timing harness all
  route through it.
* :func:`device_label` — the card's name and power limit as ``nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader`` prints them (a card
  set below its maximum runs slower under load, so every number carries it).
* :func:`env_meta` — the torch and CUDA versions and the device, stamped
  into every BENCH payload.
* :func:`merge_bench` — the BENCH schema ``repro_torch.obs.bench/v1``:
  ``{"schema", "meta", "sections": {name: payload}}``, merged by section
  name so the order of the writers does not matter.
"""
from __future__ import annotations

import json
import os
import subprocess
from typing import Iterable, Optional

__all__ = ["BENCH_SCHEMA", "device_label", "env_meta", "merge_bench",
           "percentile"]

BENCH_SCHEMA = "repro_torch.obs.bench/v1"


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """Linear-interpolated percentile (numpy's default method).

    Returns ``None`` on an empty input rather than raising — stage
    summaries routinely aggregate span sites that never fired.
    """
    xs = sorted(float(v) for v in values)
    if not xs:
        return None
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q={q} out of [0, 100]")
    if len(xs) == 1:
        return xs[0]
    rank = (q / 100.0) * (len(xs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


def device_label(device=None) -> str:
    """``"cpu"`` for a CPU device, else the card's ``name, power limit``
    line from ``nvidia-smi`` (its torch name alone where nvidia-smi cannot
    be run)."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev.type
    index = torch.cuda.current_device() if dev.index is None else dev.index
    name = torch.cuda.get_device_name(index)
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return f"{name}, power limit not read"
    line = out.stdout.strip()
    return line if out.returncode == 0 and line else (
        f"{name}, power limit not read")


def env_meta(extra: Optional[dict] = None, device=None) -> dict:
    """Environment metadata stamped into every BENCH payload."""
    import torch

    meta = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device_count": torch.cuda.device_count(),
        "device": device_label(device if device is not None else (
            "cuda" if torch.cuda.is_available() else "cpu")),
    }
    if extra:
        meta.update(extra)
    return meta


def merge_bench(path: str, section: str, payload: dict,
                meta_extra: Optional[dict] = None) -> dict:
    """Merge one section into a ``repro_torch.obs.bench/v1`` file on disk.

    Sections are independent (kernel timings, a traced path…); merging by
    name makes the final artifact independent of the writers' order.
    """
    doc: dict = {"schema": BENCH_SCHEMA, "meta": {}, "sections": {}}
    if os.path.exists(path):
        try:
            with open(path) as fh:
                prev = json.load(fh)
            if isinstance(prev, dict) and prev.get("schema") == BENCH_SCHEMA:
                doc = prev
                doc.setdefault("meta", {})
                doc.setdefault("sections", {})
        except (json.JSONDecodeError, OSError):
            pass  # start the file over rather than fail the bench
    doc["meta"].update(env_meta(meta_extra))
    doc["sections"][section] = payload
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return doc
