"""Each kernel's work a train step, by the kernel's name: ``{name: {"ops",
"bytes", "compute"}}``, where ``name`` is the part of the kernel's name
that a reader looks for in the traced stretch and ``compute`` names the
peak its operations run at (``harness/peaks.py``'s ``COMPUTE_PEAK``).

The benchmark's own entries hold for every configuration (the Adam
kernel, ``counts/adam.py``); a configuration adds those of its own
kernels in an optional ``counts/<config>.py`` whose ``kernel_work(ref,
cfg, batch)`` returns more entries, counted from the reference's shapes
(on the meta device), never from the program, so a change that replaces
a kernel reads against the same work."""

from __future__ import annotations

from pathlib import Path

from counts.adam import adam_work
from harness import spec


def kernel_work(ref, cfg: dict, batch: int, config_name: str, bench_dir: Path = spec.BENCH_DIR) -> dict:
    work = {"adam_fused_kernel": adam_work(ref, cfg)}
    own = bench_dir / "counts" / f"{config_name}.py"
    if own.exists():
        module = spec.load_module(own, f"bench_counts_{config_name}")
        if not hasattr(module, "kernel_work"):
            raise AttributeError(f"{own} defines no kernel_work(ref, cfg, batch)")
        for name, entry in module.kernel_work(ref, cfg, batch).items():
            if name in work:
                raise ValueError(f"{own}: the kernel {name!r} has an entry already")
            if set(entry) != {"ops", "bytes", "compute"}:
                raise ValueError(f"{own}: {name!r} needs ops, bytes and compute, has {sorted(entry)}")
            work[name] = entry
    return work
