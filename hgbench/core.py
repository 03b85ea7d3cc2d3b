"""The benchmark's data: ``BENCHMARK.json`` and the files each cell names.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Each lies in a file of its own, found by its name:

- the configuration: the file its ``configs`` entry names;
- the traffic mix: ``traffic/<traffic>.json``, the parameters of the driver
  it names (``drivers/<driver>.py``);
- each metric: ``metrics/<metric>.py``, whose ``read(run)`` returns the
  number or None where the run has nothing to read.

So a later cell, mix or metric is added as files and entries, and no file
that is here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]     # the configuration file's contents
    traffic: Dict[str, Any]    # the traffic file's contents
    end_to_end: List[dict]     # BENCHMARK.json's metrics reported here
    per_layer: List[dict]


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, root: str = ROOT,
              overrides: Optional[dict] = None) -> Cell:
    """The cell ``name`` with its configuration and traffic read from their
    files. ``overrides`` ({"config": {...}, "traffic": {...}}) is merged
    over both: the CPU tests shrink a cell with it, a run never does."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; options: "
                       f"{sorted(entries)}")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[w["config"]]["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    overrides = overrides or {}
    return Cell(
        name=name, chips=int(w["chips"]),
        config=merge(config, overrides.get("config", {})),
        traffic=merge(traffic, overrides.get("traffic", {})),
        end_to_end=[m for m in bench["end_to_end"] if _reported_in(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported_in(m, name)],
    )


def merge(base: dict, over: dict) -> dict:
    """``over`` merged into a copy of ``base``, nested dicts key by key."""
    out = dict(base)
    for key, value in over.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = merge(out[key], value)
        else:
            out[key] = value
    return out


def _load_file(path: str, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_driver(name: str):
    """``drivers/<name>.py``: the code that runs one kind of traffic."""
    return _load_file(os.path.join(HERE, "drivers", name + ".py"),
                      f"hgbench_driver_{name}")


def load_reader(metric: str) -> Callable:
    """``metrics/<metric>.py``'s ``read(run) -> float | None``."""
    module = _load_file(os.path.join(HERE, "metrics", metric + ".py"),
                        "hgbench_metric_" + metric.replace(".", "_")
                        .replace("-", "_"))
    return module.read


def program_config(config: dict):
    """The program's ``Config`` for a configuration file: the preset it
    names, with every field the file's ``program`` block gives set to the
    file's value. A field the preset does not have is an error."""
    from hashgan_tpu_torch.configs import get_config

    cfg = get_config(config["preset"])
    return _replace(cfg, config.get("program", {}), config["preset"])


def _replace(obj, values: dict, where: str):
    updates = {}
    for key, value in values.items():
        if not hasattr(obj, key):
            raise KeyError(f"{where}: the program's config has no {key!r}")
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current):
            updates[key] = _replace(current, value, f"{where}.{key}")
        else:
            updates[key] = tuple(value) if isinstance(current, tuple) \
                and isinstance(value, list) else value
    return dataclasses.replace(obj, **updates)
