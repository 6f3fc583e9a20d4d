"""``BENCHMARK.json`` and the files it names, resolved by name.

A cell names a configuration and a traffic mix; the configuration names its
file; the traffic mix is ``traffic/<name>.json``; every metric is
``metrics/<name>.py`` (dots in a metric's name become underscores in the
file's). A metric split by kind of cell, ``<base>.<kind>``, with no file of
its own is read by ``metrics/<base>.py``. A configuration's model family
(its weights, reference, CPU cut and work counts) is
``families/<arch_type>.py`` (``families/__init__.py``). Nothing here knows a
particular cell, configuration, family or metric, so a new one is a new file
and a new entry.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    source: str
    compute: Callable               # compute(record) -> float | None
    workloads: Optional[list] = None

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict                    # configs/<name>.json
    traffic: dict                   # traffic/<name>.json
    end_to_end: list                # [Metric] this cell reports
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def metric_file(name: str, metrics_dir: Path = HERE / "metrics") -> Path:
    own = metrics_dir / (name.replace(".", "_").replace("-", "_") + ".py")
    if own.exists() or "." not in name:
        return own
    return metric_file(name.split(".")[0], metrics_dir)


def load_metric_module(name: str, metrics_dir: Path = HERE / "metrics"):
    path = metric_file(name, metrics_dir)
    if not path.exists():
        raise FileNotFoundError(f"metric {name!r}: no reader at {path}")
    spec = importlib.util.spec_from_file_location(
        f"servebench.metrics.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "compute", None)):
        raise AttributeError(f"{path} defines no compute(record)")
    return mod


def resolve(cell_name: str, bench: Optional[dict] = None,
            root: Path = ROOT) -> Cell:
    """The cell ``cell_name`` with its configuration, traffic and metric
    readers loaded from the files their names point at."""
    bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no cell {cell_name!r}; cells: {sorted(cells)}")
    w = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = load_json(root / cfg_entry["file"])
    if config.get("name") != cfg_entry["name"]:
        raise ValueError(f"{cfg_entry['file']} names {config.get('name')!r}, "
                         f"not {cfg_entry['name']!r}")
    traffic = load_json(root / "servebench" / "traffic"
                        / f"{w['traffic']}.json")
    metrics_dir = root / "servebench" / "metrics"

    def metrics(kind):
        out = []
        for m in bench[kind]:
            metric = Metric(
                name=m["name"], unit=m["unit"], source=m["source"],
                compute=load_metric_module(m["name"], metrics_dir).compute,
                workloads=m.get("workloads"))
            if metric.applies_to(cell_name):
                out.append(metric)
        return out

    return Cell(name=cell_name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=metrics("end_to_end"),
                per_layer=metrics("per_layer"))
