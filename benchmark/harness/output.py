"""The run's result: the import check, the device record and the one
JSON line printed last on standard output."""

from __future__ import annotations

import json
import subprocess
import sys
from typing import Dict, Optional

# top-level module names the port's runs must not load: the JAX stack and
# the JAX package, compared whole ("eadgan_tpu_torch" is not "eadgan_tpu")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "eadgan_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


class RunFailure(SystemExit):
    """Ends the run with code 1 and a message on standard error, before
    any result is printed."""

    def __init__(self, message: str):
        print(f"benchmark: {message}", file=sys.stderr, flush=True)
        super().__init__(1)


def require_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise RunFailure("no CUDA card: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise RunFailure(f"the cell needs {chips} card(s), torch sees {torch.cuda.device_count()}")


def power_limit_w() -> Optional[float]:
    """The card's power limit by ``nvidia-smi``, None where it cannot say."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def device_record(memory_peak_bytes: int, count: int = 1) -> dict:
    import torch

    if torch.cuda.is_available():
        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"
    return {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind, "count": count,
            "memory_peak_bytes": int(memory_peak_bytes)}


def checks_passed(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def emit(*, correct: bool, attempted: int, failed: int, metrics: Dict[str, tuple], device: dict,
         checks: Dict[str, dict], breakdown: Optional[dict] = None, extra: Optional[dict] = None) -> None:
    """Print each compared number beside its limit as the last lines on
    standard error, then the result line as the last line on standard
    output, ``checks`` its last key.  Raises :class:`RunFailure` first
    if a forbidden module is loaded."""
    found = forbidden_modules()
    if found:
        raise RunFailure(f"modules of the JAX stack or package are loaded: {', '.join(found)}")
    line = {
        "correct": bool(correct),
        "attempted": int(attempted),
        "failed": int(failed),
        "metrics": {k: {"value": v, "unit": u} for k, (v, u) in metrics.items()},
        "device": device,
    }
    if breakdown is not None:
        line["breakdown"] = breakdown
    if extra:
        line.update(extra)
    line["checks"] = checks
    sys.stdout.flush()
    for name, c in checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
