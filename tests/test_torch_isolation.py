"""The port stands alone: every ``repro_torch`` module imports with JAX
made unimportable, and none of them loads a module of the ``repro``
package. ``chip_smoke.py`` is held to the same rule by a scan of its
imports, without running it (it needs a card)."""

import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import repro_torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
sys.modules["jax"] = None  # any "import jax" now raises ImportError
import importlib, json, pkgutil, repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "repro" or m.startswith(("repro.", "jax.", "jaxlib")))
print(json.dumps({"n": len(names), "leaked": leaked}))
"""


def test_every_module_imports_without_jax_or_repro():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    expected = 1 + len(list(pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")))
    assert got["n"] == expected and expected > 15
    assert got["leaked"] == []


def test_chip_smoke_imports_neither_jax_nor_repro():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots


_SLICE_PROBE = """
import sys
sys.modules["jax"] = None
from repro_torch.core import prng, staleness, topology
from repro_torch.core.engine import (CohortSpec, gather_clients,
                                     parse_cohort, scatter_clients,
                                     with_cohort, with_delay)
from repro_torch.core.staleness import (DelayState, GeometricDelay,
                                        StalenessConfig, parse_delay)
assert callable(prng.permutation) and callable(topology.Hierarchical.reduce_cohort)
print(sorted(m for m in sys.modules
             if m == "repro" or m.startswith(("repro.", "jax.", "jaxlib"))))
"""


def test_staleness_and_cohort_modules_stand_alone():
    """The asynchronous-round and cohort names (``core/staleness.py``,
    ``with_delay``, ``with_cohort``, ``CohortSpec``,
    ``Topology.reduce_cohort``, ``prng.permutation``) import with JAX made
    unimportable and load nothing of ``repro``."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _SLICE_PROBE], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
