"""What the benchmark may import: never JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and, on the reference's side, nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run

HERE = Path(__file__).resolve().parent
# the yardstick: what judges and reads, never the program
REFERENCE_SIDE = ("reference.py", "judge.py", "gen.py", "peaks.py", "readers.py",
                  "trace.py", "reference_sampler.py", "generators/__init__.py",
                  "generators/mock_community.py", "generators/synth.py")


def _imports(path: Path) -> set:
    """Top-level names of every module a file imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not _imports(path) & set(run.FORBIDDEN)


@pytest.mark.parametrize("path", [HERE / f for f in REFERENCE_SIDE]
                         + sorted((HERE / "metrics").glob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_side_imports_no_program(path):
    assert "desman_tpu_torch" not in _imports(path)


def test_reference_side_loads_no_program():
    mods = ", ".join("benchmark." + f[:-3].replace("/__init__", "").replace("/", ".")
                     for f in REFERENCE_SIDE)
    code = (f"import sys, {mods}; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'desman_tpu_torch', 'desman_tpu', 'jax', 'jaxlib', 'flax'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_tpu_records_read():
    for path in SOURCES:
        if path.name.startswith("test_bench_"):
            continue
        text = path.read_text()
        for name in ("BENCH_r", "MULTICHIP_", "bench.py"):
            assert name not in text, (path, name)


def test_forbidden_compares_whole_names(monkeypatch):
    import desman_tpu_torch  # noqa: F401 (the port: allowed)

    assert run.held_forbidden() == []
    monkeypatch.setitem(sys.modules, "desman_tpu_torch_like.x", object())
    assert run.held_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "desman_tpu.io", object())
    assert run.held_forbidden() == ["desman_tpu", "jax"]
