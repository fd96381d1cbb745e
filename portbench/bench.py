"""Finds a cell and everything it needs by name, from files alone:
``BENCHMARK.json`` at the checkout's root names the cells and metrics;
``workloads/<cell>.json`` names the driver, the program's options and the
limits of the comparison; ``configs/<config>.json`` and
``traffic/<mix>.json`` hold the sizes and the traffic; ``drivers/<driver>.py``
runs the cell and ``metrics/<metric>.py`` reads each per-layer metric.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict  # the BENCHMARK.json workload
    workload: dict  # workloads/<name>.json
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<mix>.json
    end_to_end: list[dict]  # the metrics this cell reports with --trace 0
    per_layer: list[dict]  # and with --trace 1
    root: pathlib.Path

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _json(path: pathlib.Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: pathlib.Path) -> dict:
    return _json(root / "BENCHMARK.json")


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    names, or every cell without the key."""
    return cell in metric.get("workloads", [cell])


def cell(name: str, root: pathlib.Path, here: pathlib.Path = HERE) -> Cell:
    """The cell ``name`` of the benchmark at ``root``, its files under
    ``here``."""
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(entries)}")
    entry = entries[name]
    config = _json(here / "configs" / f"{entry['config']}.json")
    return Cell(
        name=name, entry=entry,
        workload=_json(here / "workloads" / f"{name}.json"),
        config=config,
        traffic=_json(here / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)],
        root=root,
    )


def _load_file(path: pathlib.Path, name: str):
    if not path.exists():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, here: pathlib.Path = HERE):
    """``drivers/<name>.py`` as a module of the ``portbench`` package."""
    if (here / "drivers" / f"{name}.py").exists() and here == HERE:
        return importlib.import_module(f"portbench.drivers.{name}")
    return _load_file(here / "drivers" / f"{name}.py", f"portbench.drivers.{name}")


def metric_reader(name: str, here: pathlib.Path = HERE):
    """The ``read(window, ctx)`` of ``metrics/<name>.py``."""
    return _load_file(here / "metrics" / f"{name}.py",
                      "portbench_metric_" + name.replace(".", "_")).read
