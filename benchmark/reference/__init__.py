"""Plain references of the benchmark's configurations, by the name a
configuration file gives under ``reference``: ``reference/<name>.py``,
found by name (see ``gcn.py`` for what such a module gives)."""

import importlib.util
import os

_DIR = os.path.dirname(os.path.abspath(__file__))


def load(name: str, bench_dir: str = os.path.dirname(_DIR)):
    """The module ``<bench_dir>/reference/<name>.py``."""
    path = os.path.join(bench_dir, "reference", f"{name}.py")
    if not os.path.exists(path):
        raise KeyError(f"no reference {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"benchmark_reference_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
