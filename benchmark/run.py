"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics (``--trace 1``) as one JSON line,
the last line of standard output, after each compared number beside its
limit on standard error.  Exits 1 and prints no result without a CUDA
card (or fewer than the cell asks for), when a module of the JAX stack or
the JAX package is loaded, or when a run fails.  See ``README.md``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Optional  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# every cache the run's builds keep lives at a fixed path inside the checkout
CACHE = ROOT / ".bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ[var] = str(CACHE / sub)
os.environ.setdefault("USE_FLAX", "0")
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)


@dataclasses.dataclass
class Context:
    cell: object
    seed: int
    seconds: float
    trace: bool
    device: object
    bench_dir: Path
    t_start: float
    fault: Optional[Callable] = None


def run(argv=None, root: Path = ROOT, device=None, fault=None) -> dict:
    """Parse ``argv``, run the cell and return the result line's fields.
    ``device`` None takes the card (and refuses to run without one);
    tests pass the CPU and a ``fault`` that breaks the timed path."""
    from harness import output, spec

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = spec.cell(args.workload, root)
    import torch

    if device is None:
        output.require_card(cell.chips)
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  device=torch.device(device), bench_dir=root / "benchmark", t_start=T_START,
                  fault=fault)
    driver = spec.driver(cell.driver, ctx.bench_dir)
    result = driver.run(ctx)
    setup_s = result.pop("setup_s", None)
    if setup_s is None:
        raise RuntimeError("the driver reported no set-up time")
    metrics = {}
    breakdown = None
    extra_device = {}
    if ctx.trace:
        records = result["records"]
        records["power_limit_w"] = output.power_limit_w() if ctx.device.type == "cuda" else None
        for name, reader in spec.readers(cell.per_layer, ctx.bench_dir).items():
            value = reader.read(records)
            if value is not None:
                unit = next(m["unit"] for m in cell.per_layer if m["name"] == name)
                metrics[name] = (value, unit)
        stretch = records.get("stretch")
        if stretch:
            breakdown = {"device_ops": stretch["device_ops"], "idle_gaps": stretch["idle_gaps"]}
            extra_device = {"busy_s": stretch["busy_s"], "window_s": stretch["stretch_s"]}
        extra_device["power_limit_w"] = records["power_limit_w"]  # beside the mfu and rooflines
    else:
        metrics.update(result["end_to_end"])
        metrics["setup_s"] = (setup_s, "s")
    device_rec = output.device_record(result["memory_peak_bytes"], cell.chips)
    device_rec.update(extra_device)
    correct = output.checks_passed(result["checks"])
    return dict(correct=correct, attempted=result["attempted"], failed=result["failed"],
                metrics=metrics, device=device_rec, checks=result["checks"], breakdown=breakdown)


def main() -> None:
    from harness import output

    line = run()
    output.emit(**line)


if __name__ == "__main__":
    main()
