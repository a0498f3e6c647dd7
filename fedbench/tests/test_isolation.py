"""Nothing the benchmark runs imports JAX or the JAX package (``repro``),
compared by whole top-level name, and the reference imports nothing of
the port (``repro_torch``)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "fedbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub=""):
    return [p for p in (BENCH / sub).rglob("*.py") if "tests" not in p.parts]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = _imports(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_reference_sources_import_nothing_of_the_port():
    for path in _sources("reference"):
        names = _imports(path)
        assert "repro_torch" not in names, path
        assert not names & FORBIDDEN, path


def _modules_after(code: str, with_src: bool) -> set:
    path = [str(ROOT)] + ([str(ROOT / "src")] if with_src else [])
    prog = (f"import sys; sys.path[:0] = {path!r}; {code}; import json; "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=600, cwd=ROOT, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_without_the_port():
    """The reference modules import with the program off the path, and
    leave neither the port nor JAX in ``sys.modules``."""
    mods = _modules_after(
        "import fedbench.reference.moe, fedbench.reference.ssm, "
        "fedbench.reference.fedcet, fedbench.counts, fedbench.prng, "
        "fedbench.traffic_gen, fedbench.readings", with_src=False)
    assert not mods & (FORBIDDEN | {"repro_torch"}), sorted(mods)


def test_a_cpu_run_holds_no_jax():
    """A whole run of a cell on the CPU at test sizes (program, window,
    reference) leaves no forbidden module in the process."""
    mods = _modules_after(
        "import torch; torch.set_num_threads(2); from fedbench import run; "
        "c = run.load_cell('granite-moe-l2.shiftq8-arena'); "
        "run.run_cell(c, 3, 0.0, False, device='cpu', test_sizes=True); "
        "assert not run.forbidden_modules()", with_src=True)
    assert "repro_torch" in mods
    assert not mods & FORBIDDEN, sorted(mods & FORBIDDEN)
