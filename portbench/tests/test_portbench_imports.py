"""Nothing under portbench/ imports JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), nothing
under portbench/reference/ imports the program, and no file reads the JAX
package's benchmarks or configurations."""
import ast

import pytest

from portbench import harness

FILES = sorted(harness.BENCH.rglob("*.py"))


def imported(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_no_jax_or_jax_package(path):
    assert not set(imported(path)) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((harness.BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "sleepgen_torch" not in set(imported(path))
    assert "portbench" not in set(imported(path))


def test_the_forbidden_names_are_compared_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "sleepgen_torch_extra", types.ModuleType("x"))
    assert "sleepgen" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sleepgen.configs", types.ModuleType("y"))
    assert "sleepgen" in harness.forbidden_modules()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_no_file_reads_the_jax_benchmarks_or_configs(path):
    if path.parent.name == "tests":
        return
    text = path.read_text()
    for needle in ("benches/", "bench.py", "sleepgen/configs", "BENCH_r", "MULTICHIP_r",
                   "SERVE_r4", "BASELINE.json"):
        assert needle not in text, needle
