"""The readings a cell's limits are set from, on the card, at the cell's
own sizes, for many seeds in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> [<n> ...]
        [--control <k>] [--faults <name,...>] [--fault-seeds <k>]
        [--out <file.jsonl>]

For each seed, the numbers the cell compares, of the program against the
reference (the lower readings); for the first ``--control`` seeds, of the
control against the reference: the reference put in the program's place
and computed one precision lower than the configuration states (float8
e4m3 products, e5m2 gradients, for bf16); for the first ``--fault-seeds``
seeds, of the program with each fault of ``harness/faults.py`` planted
under its timed path.  The readings need no measured window: set-up's
first steps are what is compared.  One JSON line per reading on standard
output and in ``--out``.
"""

import argparse
import gc
import json
import sys
import time

import run as runner  # sets the caches and the import path

from harness import compare, faults, output, spec

CONTROL = "fp8"


def _readings(ctx, control: bool):
    driver = spec.driver("train", ctx.bench_dir)
    f = driver.first_steps(ctx)
    first, states, ref, weights, batches, rng_seed = f.first, f.states, f.ref, f.weights, f.batches, f.rng_seed
    del f
    gc.collect()
    cfg, device = ctx.cell.config, ctx.device
    expect = compare.reference_first_steps(ref, cfg, weights, batches, rng_seed, device)
    followed = compare.followed_grads(ref, cfg, weights, states, batches, rng_seed, device)
    out = {"program": compare.train_gaps(first, expect, followed)}
    if control:
        lower = compare.reference_first_steps(ref, cfg, weights, batches, rng_seed, device,
                                              quant=CONTROL, keep_states=True)
        followed = compare.followed_grads(ref, cfg, weights, lower["states"], batches, rng_seed, device)
        out["control"] = compare.train_gaps(lower, expect, followed)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--faults", default="")
    parser.add_argument("--fault-seeds", type=int, default=3)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)

    import torch

    cell = spec.cell(args.workload, runner.ROOT)
    output.require_card(cell.chips)
    device = torch.device("cuda", 0)
    sink = open(args.out, "a") if args.out else None

    def emit(record):
        line = json.dumps(record)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        ctx = runner.Context(cell=cell, seed=seed, seconds=0.0, trace=False, device=device,
                             bench_dir=runner.BENCH_DIR, t_start=time.perf_counter())
        record = _readings(ctx, control=i < args.control)
        emit({"workload": cell.name, "seed": seed, **record, "seconds": time.perf_counter() - t0})
        gc.collect()
        torch.cuda.empty_cache()
    for name in [n for n in args.faults.split(",") if n]:
        for seed in args.seeds[:args.fault_seeds]:
            ctx = runner.Context(cell=cell, seed=seed, seconds=0.0, trace=False,
                                 device=device, bench_dir=runner.BENCH_DIR,
                                 t_start=time.perf_counter(), fault=faults.TRAIN[name])
            record = _readings(ctx, control=False)
            emit({"workload": cell.name, "seed": seed, "fault": name, **record})
            gc.collect()
            torch.cuda.empty_cache()
    if sink:
        sink.close()
    found = output.forbidden_modules()
    if found:
        print(f"calibrate: forbidden modules loaded: {found}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
