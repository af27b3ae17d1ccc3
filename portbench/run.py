#!/usr/bin/env python3
"""The benchmark of diffqcqp_tpu_torch, the PyTorch and CUDA package, on one
or more NVIDIA cards.

    python3 portbench/run.py --workload nnqp24.train --seed 7 --seconds 10 --trace 0

The cell named by ``--workload`` is looked up in BENCHMARK.json at the root
of the checkout; its configuration, traffic mix, cell file and per-layer
metric readers are files under ``portbench/`` found by name:

    portbench/configs/<config>.json      sizes, input law, solver settings
    portbench/traffic/<traffic>.json     what a step does (forward, backward)
    portbench/workloads/<cell>.json      pool of input batches, limits of the check
    portbench/problems/<problem>.py      input law, step and answers of a problem class
    portbench/reference/<problem>.py     its plain reference (imports nothing of the package)
    portbench/metrics/<metric>.py        read(ctx) -> value or None

Set-up makes the input pool on the device from ``--seed``, warms up and
captures the cell's one step, then the window drives it for ``--seconds``
(``--trace 1``: a short untraced window, then one of the same length under
``torch.profiler``; the run prints the cell's per-layer metrics in place of
its end-to-end ones). Once the window has closed the kept answers are
compared with the reference, and the last line of standard output is one
JSON object: correct, attempted, failed, metrics, device (and breakdown when
traced), then checks, each compared number beside its limit.

Exit codes: 0 a result was printed; 1 no card, or fewer than the cell asks
for; 2 a bad argument or a missing file; 3 a JAX module was loaded.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / ".portbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "diffqcqp_tpu")


class Refused(Exception):
    """No result: the message goes to standard error, ``code`` is the exit code."""

    def __init__(self, msg: str, code: int):
        super().__init__(msg)
        self.code = code


def process_start() -> float:
    """The wall-clock time this process started, from /proc where it can be
    read, else the time this module began to run."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        started = float(fields[19]) / os.sysconf("SC_CLK_TCK")
        return min(T0, time.time() - (uptime - started))
    except (OSError, ValueError, IndexError):
        return T0


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def _json(path: Path) -> dict:
    if not path.is_file():
        raise Refused(f"{path} is missing", 2)
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell's entry of BENCHMARK.json with its configuration, traffic mix
    and cell file, and the metrics it reports."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})", 2)
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[cell["config"]]["file"])
    traffic = _json(root / "portbench" / "traffic" / f"{cell['traffic']}.json")
    spec = _json(root / "portbench" / "workloads" / f"{name}.json")

    def applies(m):
        return name in m.get("workloads", [name])

    return {
        "cell": cell, "config": config, "traffic": traffic, "spec": spec,
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_info(torch, device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        lines = r.stdout.strip().splitlines() if r.returncode == 0 else []
        return lines[0] if lines else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


class Context:
    """What a per-layer metric reader sees: the configuration, the traced
    window (``trace``, its loop's ``window``), the untraced window of the
    same length run right before it (``untraced``), the reference's
    findings per pool slot (``reference``), the batch size and the steps
    traced."""

    def __init__(self, spec, trace, untraced, reference):
        self.config = spec["config"]
        self.trace, self.untraced, self.reference = trace, untraced, reference
        self.window = trace.window
        self.batch = spec["config"]["batch"]
        self.steps = trace.window.steps


def read_metric(name: str, ctx: Context):
    mod = importlib.import_module(f"portbench.metrics.{name}")
    return mod.read(ctx)


def compare(problem, kept, pool, traffic) -> tuple:
    """The kept answers against the reference, one pool slot at a time.
    Returns (Comparison, {slot: reference info})."""
    from portbench.check import Comparison

    cmp = Comparison()
    infos = {}
    by_slot: dict[int, list] = {}
    for slot, out in kept:
        by_slot.setdefault(slot, []).append(out)
    for slot in sorted(by_slot):
        want, info = problem.reference(pool[slot], traffic)
        for out in by_slot[slot]:
            cmp.add(problem.answers(out, traffic), want, info)
        infos[slot] = {k: v for k, v in info.items() if k != "well_posed"}
        del want
    return cmp, infos


def main(argv=None, device=None, overrides=None) -> dict:
    """One run; returns the result it prints. ``device`` (a test's CPU) skips
    the look for a card; ``overrides`` ({"config": {...}, "spec": {...}})
    replaces keys of the configuration and of the cell's file."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()

    spec = load_cell(args.workload)
    cell, cfg, traffic, wl = spec["cell"], spec["config"], spec["traffic"], spec["spec"]
    if overrides:
        cfg = spec["config"] = {**cfg, **overrides.get("config", {})}
        wl = spec["spec"] = {**wl, **overrides.get("spec", {})}

    t = time.time()
    import torch

    split = {"import_torch_s": time.time() - t}
    t = time.time()
    chips = int(cell["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise Refused(f"the cell needs {chips} CUDA card(s); torch sees "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", 1)
        device = torch.device("cuda:0")
        torch.cuda.set_device(device)
        torch.empty(1, device=device)       # the card's context
    split["cuda_init_s"] = time.time() - t
    t = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    dqt = importlib.import_module(cfg["package"])
    staged = importlib.import_module(f"{cfg['package']}.utils").staged
    dqt.enable_compilation_cache(str(ROOT / cfg["package"] / "_build"))
    problem = importlib.import_module(f"portbench.problems.{cfg['problem']}")
    from portbench import loop, trace
    from portbench.check import verdict

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    split["import_package_s"] = time.time() - t

    t = time.time()
    pool = problem.make_pool(cfg, int(wl["pool"]), args.seed, device)
    sync()
    split["inputs_s"] = time.time() - t

    fn, counts = problem.make_step(cfg, traffic, device)
    step = staged(fn)
    t = time.time()
    step(*pool[0])                 # builds the kernels on a checkout's first run
    sync()
    split["first_call_s"] = time.time() - t
    t = time.time()
    for k in range(1, len(pool) + 4):      # the other warm-up calls, the capture, a replay a slot
        step(*pool[k % len(pool)])
    loop.warm_allocator(step, pool)
    sync()
    split["warmup_capture_s"] = time.time() - t
    setup_s = time.time() - t_start
    split["before_import_s"] = setup_s - sum(split.values())
    log("setup: " + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
        + f"; setup_s {setup_s:.4f}")

    if args.trace:
        # the host's times are read untraced: the profiler slows the host path
        seconds = min(args.seconds, trace.TRACE_SECONDS)
        untraced = loop.run(step, pool, counts, seconds, device)
        untraced.kept = []       # so the traced window allocates nothing new
        tr = trace.run(step, pool, counts, seconds, device)
        w = tr.window
    else:
        w = loop.run(step, pool, counts, args.seconds, device)
    dev_info = card_info(torch, device, chips)
    del step
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.time()
    cmp, infos = compare(problem, w.kept, pool, traffic)
    ok, checks = verdict(cmp.numbers(), wl["limits"])
    log(f"check: {cmp.compared} answers of {len(w.kept)} kept steps against the reference in "
        f"{time.time() - t:.2f} s; gradients judged on {cmp.judged_grads}; the reference's worst "
        f"KKT residual {cmp.kkt:.3e}")

    B = int(cfg["batch"])
    attempted = B * w.steps
    result = {"correct": ok, "attempted": attempted, "failed": attempted - w.converged}
    if args.trace:
        ctx = Context(spec, tr, untraced, infos)
        metrics = {}
        for m in spec["per_layer"]:
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info["busy_s"] = tr.busy_s()
        dev_info["window_s"] = tr.window_s
        result.update(metrics=metrics, device=dev_info, breakdown=tr.breakdown())
    else:
        import numpy as np

        values = {
            "problems_per_s": B * w.steps / w.seconds,
            "step_ms_p95": float(np.percentile(np.asarray(w.latency) * 1e3, 95)),
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]}
        result.update(metrics=metrics, device=dev_info)
    log(f"window: {w.steps} steps in {w.seconds:.4f} s, {w.converged} of {attempted} problems "
        f"converged, mean iterations {w.iterations / max(attempted, 1):.4f}; card "
        f"{power_limit() if device.type == 'cuda' else 'none (cpu)'}")
    result["checks"] = checks
    bad = forbidden_modules()
    if bad:
        raise Refused(f"JAX modules were loaded in this process: {bad}", 3)
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    return result


if __name__ == "__main__":
    try:
        res = main()
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        sys.exit(e.code)
    print(json.dumps(res))
