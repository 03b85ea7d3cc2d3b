"""Run one cell of the benchmark and print its result line.

    python3 hgbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run builds the cell's program objects and
inputs from ``--seed`` (set-up, ``setup_s``, counted from this file's first
line), measures for ``--seconds``, then checks what the timed path produced
against the plain reference. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, read in a
profiled window of at most ``TRACE_SECONDS``), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``: each number compared with its limit, which also end standard
error. Earlier lines give the card, its power limit and clocks, and what a
cell's driver notes.

It exits non-zero and prints no result where no CUDA device is visible,
where fewer cards are visible than the cell asks for, where anything fails,
and where the process holds ``jax``, ``jaxlib``, ``flax`` or
``hashgan_tpu`` once the window has closed.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# import the benchmark as the package ``hgbench`` from the checkout's root,
# and keep this folder off the path, where its modules would shadow others
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, ROOT)

# Kernel caches at fixed paths inside the checkout, so that only a cell's
# first run in a checkout compiles (the program's nvcc library has its own
# fixed folder, hashgan_tpu_torch/csrc/build/).
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = os.path.join(ROOT, ".hgbench_cache", _sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "hashgan_tpu")
TRACE_SECONDS = 10.0


def forbidden_modules(modules=None):
    """Top-level names in ``sys.modules`` (the part before the first dot,
    compared whole) that the benchmark must never load."""
    modules = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in list(modules)}
    return sorted(tops.intersection(FORBIDDEN))


def card_lines():
    """The card's name, power limit and clocks, as ``nvidia-smi`` reads
    them (each number kept has these beside it)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit,clocks.sm,"
             "clocks.max.sm,clocks.mem,temperature.gpu",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return [f"card: nvidia-smi unavailable ({e})"]
    return ["card (index, name, power limit, SM clock, max SM clock, "
            f"memory clock, temperature): {line.strip()}"
            for line in out.strip().splitlines()]


def execute(cell, seed: int, seconds: float, trace: bool, device: str,
            t_start: float):
    """Set up, measure and check one run of ``cell``. Returns
    (result dict, RunRecord). ``device`` is "cuda" on the card; the CPU
    tests pass "cpu" with a shrunken cell."""
    import contextlib

    import torch

    from hgbench import core
    from hgbench.record import RunRecord
    from hgbench.tracing import WINDOW, Tracer

    if trace:  # a profiled window of at most TRACE_SECONDS holds the
        seconds = min(seconds, TRACE_SECONDS)  # trace to a few hundred MB
    record = RunRecord(cell=cell, seed=seed, seconds=seconds, device=device)
    driver = core.load_driver(cell.traffic["driver"]).Driver(record)
    driver.setup()
    record.setup_s = time.time() - t_start
    if trace:
        with Tracer() as tracer:
            driver.window(seconds, lambda: torch.profiler.record_function(
                WINDOW))
        record.trace = tracer.summary
    else:
        driver.window(seconds, contextlib.nullcontext)
    peak = 0
    if device == "cuda":
        peak = max(torch.cuda.max_memory_allocated(d)
                   for d in range(cell.chips))
    driver.release()
    record.checks = driver.check()
    correct = bool(record.checks) and all(
        v <= lim for v, lim in record.checks.values())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = core.load_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    info = {"platform": "gpu" if device == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                     else "cpu"),
            "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(record.attempted),
              "failed": int(record.failed), "metrics": metrics,
              "device": info}
    if trace:
        info["busy_s"] = record.trace.busy_s
        info["window_s"] = record.trace.window_s
        result["breakdown"] = record.trace.breakdown()
    result["checks"] = {k: {"value": float(v), "limit": float(lim)}
                        for k, (v, lim) in record.checks.items()}
    return result, record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # One host thread for the CPU's own operators: the cells are paced by
    # one Python thread that launches the card's work, and a pool of
    # intra-op threads spinning beside it takes a quarter more CPU time for
    # no gain in rate (set before torch is imported, which reads it once).
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    try:
        from hgbench import core

        cell = core.find_cell(core.load_benchmark(ROOT), args.workload)
        import torch

        if not torch.cuda.is_available():
            print("no CUDA device is visible: the benchmark runs only on the "
                  "card", file=sys.stderr)
            return 3
        if torch.cuda.device_count() < cell.chips:
            print(f"{args.workload} needs {cell.chips} cards and "
                  f"{torch.cuda.device_count()} are visible", file=sys.stderr)
            return 3
        for line in card_lines():
            print(line, flush=True)
        result, record = execute(cell, args.seed, args.seconds,
                                 bool(args.trace), "cuda", T_START)
    except Exception:  # a boundary: report the failure, print no result
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print(f"the process loaded {', '.join(found)}: the benchmark and the "
              "program must not import JAX or the JAX package",
              file=sys.stderr)
        return 4
    for line in record.notes:
        print(line)
    print(f"set-up {record.setup_s:.3f} s, window {record.window_s:.3f} s, "
          f"attempted {record.attempted}, failed {record.failed}")
    sys.stdout.flush()
    for name, (value, limit) in record.checks.items():
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
