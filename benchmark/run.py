#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``wfl_asr_tpu_torch``.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration (``benchmark/configs/<config>.json``) and traffic mix
(``benchmark/traffic/<traffic>.json``); the mix names the driver that
serves it (``benchmark/drivers/<driver>.py``); each per-layer metric is
read by ``benchmark/metrics/<name>.py``; the output check's limits are
in ``benchmark/checks/<workload>.json``. A later cell, mix or metric is
added by adding such files.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` and,
traced, ``breakdown``; last of all ``checks``, each compared number with
its limit, which also close standard error. The set-up split is printed
on an earlier line (``[setup]``).

Without a CUDA device, or with fewer than the cell's chips, the run exits
with 2 and prints no result; so it does when a module of JAX or of the
JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "benchmark")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


THREADS = 2


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; no JAX through a
    library; a fixed, small pool of intra-op threads whatever the
    machine's cores, so that the training loader's workers and the
    launching thread keep theirs."""
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, ".bench_cache", "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    import torch
    torch.set_num_threads(THREADS)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench: dict, workload: str, bench_dir: str = BENCH_DIR):
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(os.path.join(os.path.dirname(bench_dir),
                                    conf["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic",
                                     cell["traffic"] + ".json"))
    limits = load_json(os.path.join(bench_dir, "checks", workload + ".json"))
    return cell, config, traffic, limits


def _applies(metric: dict, cell: dict) -> bool:
    return cell["name"] in metric.get("workloads", [cell["name"]])


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             bench_dir: str = BENCH_DIR) -> dict:
    """Set up, measure and check one run; returns the result object."""
    cell, config, traffic, limits = cell_files(bench, workload, bench_dir)
    driver = _load_module(os.path.join(bench_dir, "drivers",
                                       traffic["driver"] + ".py"),
                          "bench_driver_" + traffic["driver"])
    work = tempfile.mkdtemp(prefix="wfl_bench_")
    try:
        run = driver.run(dict(cell=cell, config=config, traffic=traffic,
                              limits=limits, seed=seed, seconds=seconds,
                              trace=trace, device=device, work=work,
                              t_start=T_START))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("[setup] " + " ".join(f"{k}={v:.3f}" for k, v in
                                run["setup_split"].items()), flush=True)
    if run.get("host"):
        print("[host] " + " ".join(f"{k}={v:.3f}" if isinstance(v, float)
                                   else f"{k}={v}"
                                   for k, v in run["host"].items()),
              flush=True)
    from benchmark.core.guard import forbidden_modules
    found = forbidden_modules()
    if found:
        print(f"[guard] modules of JAX or of the JAX package loaded: "
              f"{found}", file=sys.stderr, flush=True)
        raise SystemExit(3)
    metrics = {}
    if not trace:
        for m in bench["end_to_end"]:
            if _applies(m, cell) and m["name"] in run["e2e"]:
                metrics[m["name"]] = {"value": run["e2e"][m["name"]],
                                      "unit": m["unit"]}
    else:
        reported = {m["name"] for m in bench["end_to_end"]
                    if _applies(m, cell)}
        for m in bench["per_layer"]:
            if not _applies(m, cell) or m["moves"] not in reported:
                continue
            reader = _load_module(os.path.join(bench_dir, "metrics",
                                               m["name"] + ".py"),
                                  "bench_metric_" + m["name"].replace(
                                      ".", "_").replace("-", "_"))
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = run["device"]
    out = {"correct": bool(run["correct"]), "attempted": run["attempted"],
           "failed": run["failed"], "metrics": metrics, "device": dev}
    if trace and run.get("breakdown"):
        out["breakdown"] = run["breakdown"]
    out["checks"] = {n: {"value": v, "limit": lim}
                     for n, v, lim in run["checks"]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = next((w["chips"] for w in bench["workloads"]
                  if w["name"] == args.workload), 1)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"[card] {power_limit()}", flush=True)
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    for name, c in out["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
