#!/usr/bin/env python3
"""Readings that the limits of a cell's check are set from, on the card.

    python3 portbench/calibrate.py --workload nnqp24.train --seeds 101-112 \
        --control-seeds 201-203 --seconds 2

In one process: the program's readings (the numbers ``check.py`` compares)
on each of ``--seeds``, each from a window of ``--seconds`` at the cell's
own load, as a run takes them; then the control's on each of
``--control-seeds``: the plain reference computed in TF32 (float32 with
every product's operands rounded to 10 mantissa bits), put in the
program's place at the cell's size and held against the float64 reference
the same way. Prints one JSON line per seed and a summary: the lower
reading (largest over the program's seeds) and the upper one (smallest
over the control's) of each number. The benchmark's runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import run  # noqa: E402  (sets the cache directories first)


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def main(argv=None, device=None, overrides=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control-seeds", type=seeds, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import importlib

    import torch

    from portbench import loop
    from portbench.check import Comparison

    spec = run.load_cell(args.workload)
    cfg, traffic, wl = spec["config"], spec["traffic"], spec["spec"]
    if overrides:
        cfg = {**cfg, **overrides.get("config", {})}
        wl = {**wl, **overrides.get("spec", {})}
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("calibrate: needs a CUDA card")
        device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    problem = importlib.import_module(f"portbench.problems.{cfg['problem']}")
    staged = importlib.import_module(f"{cfg['package']}.utils").staged
    fn, counts = problem.make_step(cfg, traffic, device)
    step = staged(fn)
    program, control = [], []
    for seed in args.seeds:
        pool = problem.make_pool(cfg, int(wl["pool"]), seed, device)
        for k in range(len(pool) + 4):
            step(*pool[k % len(pool)])
        loop.warm_allocator(step, pool)
        w = loop.run(step, pool, counts, args.seconds, device)
        t = time.time()
        cmp, _ = run.compare(problem, w.kept, pool, traffic)
        line = {"side": "program", "seed": seed, "steps": w.steps, "numbers": cmp.numbers(),
                "judged_grads": cmp.judged_grads, "compared": cmp.compared,
                "kkt": cmp.kkt, "check_s": time.time() - t}
        print(json.dumps(line), flush=True)
        program.append(line)
        del w, cmp, pool
    for seed in args.control_seeds:
        pool = problem.make_pool(cfg, int(wl["pool"]), seed, device)
        cmp = Comparison()
        for x in pool:
            want, info = problem.reference(x, traffic)
            got, _ = problem.reference(x, traffic, precision="tf32")
            cmp.add(got, want, info)
        line = {"side": "control", "seed": seed, "numbers": cmp.numbers(),
                "judged_grads": cmp.judged_grads, "compared": cmp.compared}
        print(json.dumps(line), flush=True)
        control.append(line)
    names = sorted(program[0]["numbers"]) if program else []
    summary = {"summary": args.workload,
               "lower": {k: max(p["numbers"][k] for p in program) for k in names},
               "upper": ({k: min(c["numbers"][k] for c in control) for k in names}
                         if control else {})}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
