"""What the benchmark may import: nothing of JAX or the JAX package anywhere,
and the reference nothing of the program either (top-level names compared
whole: ``lxt_tpu_torch`` is the program, ``lxt_tpu`` the JAX package)."""

import ast
import subprocess
import sys

import pytest
from tiny import BENCH, ROOT

NEVER = {"jax", "jaxlib", "flax", "lxt_tpu"}


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(*parts):
    return sorted(p for p in BENCH.joinpath(*parts).rglob("*.py")
                  if "tests" not in p.relative_to(BENCH).parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not _top_level_imports(path) & NEVER


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        imported = _top_level_imports(path)
        assert not imported & (NEVER | {"lxt_tpu_torch"}), path
        assert imported <= {"torch", "bench_port", "math"}, (path, imported)
    # and what it imports of the benchmark is the reference's own
    for path in _sources("reference"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module.startswith("bench_port"):
                assert node.module == "bench_port.reference", path


def test_a_run_loads_no_jax():
    """Everything a run imports, the program included, loads no module of
    JAX or of the JAX package (``lxt_tpu_torch`` shares its first letters
    with ``lxt_tpu``: the names are compared whole)."""
    code = ("import sys; sys.path.insert(0, %r); sys.argv = ['run']\n"
            "import bench_port.run as run\n"
            "from bench_port.harness import runner, spec\n"
            "import lxt_tpu_torch.pipeline, lxt_tpu_torch.models.registry\n"
            "for c in ('mistral-7b-v0.3.batch-mixed', 'mixtral-8x7b-nf4.docs-4k'):\n"
            "    cell = spec.Cell(c); cell.readers(True); cell.readers(False)\n"
            "print(runner.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_runs_check_compares_names_whole(monkeypatch):
    from bench_port.harness import runner
    before = runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "lxt_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert runner.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "lxt_tpu.ops", sys)
    assert "lxt_tpu" in runner.forbidden_modules()
