"""Where the harness finds a cell, a configuration and a per-layer metric: each
by its name, in a file of its own. A later cell, configuration or metric is a
new file; no existing one is edited."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# the top-level module names no run may load (compared whole: the port's
# name starts with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "maniskill_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(name: str) -> dict:
    """``workloads/<name>.json``: the configuration, the driver, the
    traffic mix (``traffic/<traffic>.json``, read into ``traffic``) and the
    check of one cell."""
    cell = load_json(HERE / "workloads" / f"{name}.json")
    cell.setdefault("name", name)
    cell["traffic_name"] = cell["traffic"]
    cell["traffic"] = traffic(cell["traffic"])
    return cell


def traffic(name: str) -> dict:
    """``traffic/<name>.json``: the parameters the cell's driver draws its
    inputs by (batch, observations, episode staggering, trainer settings)."""
    return load_json(HERE / "traffic" / f"{name}.json")


def config(name: str) -> dict:
    """``configs/<name>.json``: what the env is made with."""
    cfg = load_json(HERE / "configs" / f"{name}.json")
    cfg.setdefault("name", name)
    return cfg


def benchmark() -> Optional[dict]:
    path = ROOT / "BENCHMARK.json"
    return load_json(path) if path.exists() else None


def metric_reader(name: str) -> Callable:
    """``read`` of ``metrics/<name>.py``: the traced run's records to a
    number, or None where it finds nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"simbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(cell: str, reported: List[str], bench: Optional[dict]) -> Dict[str, List[dict]]:
    """The end-to-end and per-layer metric entries of ``BENCHMARK.json``
    that ``cell`` reports. ``reported`` names the end-to-end metrics its
    driver measures; a cell that ``BENCHMARK.json`` does not name reports
    all of them and no per-layer metric."""
    if bench is None or cell not in {w["name"] for w in bench.get("workloads", [])}:
        return {"end_to_end": [{"name": n} for n in reported], "per_layer": []}
    e2e = [m for m in bench["end_to_end"]
           if m["name"] in reported and cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in names and cell in m.get("workloads", [cell])]
    return {"end_to_end": e2e, "per_layer": per_layer}


def loaded_forbidden(modules) -> List[str]:
    """The names in ``modules`` whose top-level name is forbidden."""
    return sorted(n for n in modules if n.split(".", 1)[0] in FORBIDDEN_MODULES)
