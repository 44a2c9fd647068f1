"""A CPU rehearsal of a run loads neither JAX nor the JAX package: the
top-level name of each loaded module, the part before the first dot, is
compared whole (``hcspmm_tpu_torch`` begins with ``hcspmm_tpu``)."""

import json
import os
import subprocess
import sys
import types

from benchmark import harness

ROOT = harness.ROOT

REHEARSAL = """
import json, sys, tempfile
sys.path.insert(0, {tests!r})
import conftest
from benchmark import harness
root = conftest.make_root(tempfile.mkdtemp(dir={tmp!r}))
for trace in (False, True):
    conftest.rehearse(root, "tiny.tband", trace=trace)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_rehearsal_loads_no_jax(tmp_path):
    code = REHEARSAL.format(tests=os.path.dirname(os.path.abspath(__file__)), tmp=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "hcspmm_tpu_torch" in names and "benchmark" in names
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)


def test_forbidden_names_compared_whole(monkeypatch):
    for name in harness.FORBIDDEN:
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "hcspmm_tpu_torch_extra", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "hcspmm_tpu.ops", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["hcspmm_tpu"]


def test_no_result_without_a_card(tmp_path):
    """On a machine with no CUDA card the command prints no result and
    exits with another code than 0."""
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "gcn6.gh",
                          "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
