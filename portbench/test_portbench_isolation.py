"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
and the references and the frozen counter import nothing of the port."""
import ast
import os

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _modules():
    for d, _, files in os.walk(harness.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    paths = list(_modules())
    assert len(paths) > 20
    for p in paths:
        assert not set(_imports(p)) & FORBIDDEN, p


def test_references_and_counter_import_nothing_of_the_port():
    mine = [p for p in _modules() if os.sep + "reference" + os.sep in p
            or p.endswith(os.sep + "counts.py")]
    assert len(mine) >= 4
    for p in mine:
        assert "repro_torch" not in set(_imports(p)), p
