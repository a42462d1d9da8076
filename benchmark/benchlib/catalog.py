"""Everything of a cell is found by its name in ``BENCHMARK.json``: a
configuration in ``configs/<name>.json``, a cell in
``workloads/<name>.json`` (its configuration, traffic, chips and the
limits of its comparisons), a traffic mix in ``traffic/<name>.json`` (its
driver and parameters), a driver in ``drivers/<name>.py`` and a per-layer
metric's reader in ``metrics/<name>.py``.  Adding one is adding a file."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def check_name(name: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"{name!r} is not a valid name")
    return name


def path(kind: str, name: str, ext: str, root: Path = ROOT) -> Path:
    return root / kind / f"{check_name(name)}{ext}"


def load(kind: str, name: str, root: Path = ROOT) -> dict:
    """The JSON file ``<kind>/<name>.json``."""
    return json.loads(path(kind, name, ".json", root).read_text())


def names(kind: str, ext: str, root: Path = ROOT) -> list[str]:
    """Every name with a file in ``<kind>/``."""
    return sorted(p.name[:-len(ext)] for p in (root / kind).glob(f"*{ext}"))


def module(kind: str, name: str, root: Path = ROOT):
    """The Python file ``<kind>/<name>.py``, loaded by its path."""
    p = path(kind, name, ".py", root)
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, root: Path = ROOT) -> dict:
    """A cell with its configuration and traffic merged in: ``spec`` (the
    cell's file), ``config``, ``traffic``."""
    spec = load("workloads", name, root)
    return dict(name=name, spec=spec, config=load("configs", spec["config"],
                                                  root),
                traffic=load("traffic", spec["traffic"], root))
