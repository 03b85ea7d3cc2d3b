"""A cell, a configuration, a traffic mix and a metric are added as files
and entries alone: a copy of the benchmark gains a dummy cell without an
edit to any file that was there, and runs it (on the CPU, shrunken)."""

import json
import os
import shutil
import subprocess
import sys

HGBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HGBENCH)


def _snapshot(folder):
    out = {}
    for base, _, files in os.walk(folder):
        for f in files:
            p = os.path.join(base, f)
            if "__pycache__" not in p:
                out[os.path.relpath(p, folder)] = open(p, "rb").read()
    return out


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(HGBENCH, root / "hgbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _snapshot(root / "hgbench")

    small = json.load(open(root / "hgbench" / "configs" / "config5.json"))
    small["name"] = "config5_small"
    small["program"]["data"]["n_database"] = 8192
    (root / "hgbench" / "configs" / "config5_small.json").write_text(
        json.dumps(small))
    (root / "hgbench" / "traffic" / "codes-q32.json").write_text(json.dumps(
        {"driver": "query_codes", "queries_per_call": 32, "k": 10,
         "mode": "exact", "pool_calls": 3, "checked_calls": 1}))
    (root / "hgbench" / "metrics" / "calls_per_s.py").write_text(
        "def read(run):\n"
        "    return run.counters['calls'] / run.window_s\n")
    bench = json.load(open(root / "BENCHMARK.json"))
    bench["configs"].append({"name": "config5_small", "source": "x",
                             "file": "hgbench/configs/config5_small.json",
                             "reduced": ["data"], "why": "a test"})
    bench["workloads"].append({"name": "config5_small.codes-q32",
                               "config": "config5_small",
                               "traffic": "codes-q32", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("config5_small.codes-q32")
    bench["per_layer"].append({"name": "calls_per_s", "unit": "calls/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "service", "moves": "queries_per_s",
                               "workloads": ["config5_small.codes-q32"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _snapshot(root / "hgbench")
    assert all(after[k] == v for k, v in before.items())  # nothing edited

    code = f"""
import json, sys, time
sys.path[:0] = [{str(root)!r}, {ROOT!r}]
from hgbench import core
from hgbench.run import execute
assert core.HERE.startswith({str(root)!r})
cell = core.find_cell(core.load_benchmark({str(root)!r}),
                      "config5_small.codes-q32", root={str(root)!r})
for trace in (False, True):
    res, _ = execute(cell, 2**31 + 9, 0.5, trace, "cpu", time.time())
    print(json.dumps(res))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=str(root))
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = (json.loads(line) for line in
                     out.stdout.strip().splitlines()[-2:])
    assert plain["correct"] and traced["correct"], (plain, traced)
    assert set(plain["metrics"]) == {"queries_per_s", "setup_s"}
    assert set(traced["metrics"]) == {"calls_per_s"}
    assert list(traced)[-1] == "checks"
