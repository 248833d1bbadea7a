"""Holds ``tests/conftest.py::SLOW`` to its rule, by reading source only.

Every listed id must name a test that exists, and no listed test may be a
test of the port: no ``test_torch_*`` file, and no import of the port,
the benchmark or the native reader, also through another test file.
"""

import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_MODULES = {"deblur4dgs_tpu_torch", "benchmark", "native"}


def _slow_ids():
    tree = ast.parse((ROOT / "tests" / "conftest.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", None) == "SLOW":
            return ast.literal_eval(node.value)
    raise AssertionError("tests/conftest.py defines no SLOW")


def _imported(path):
    """Dotted names that ``path`` imports, also inside functions."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
            names |= {f"{node.module}.{a.name}" for a in node.names}
    return names


def test_every_slow_id_names_a_test():
    ids = _slow_ids()
    assert ids and len(set(ids)) == len(ids)
    for nodeid in ids:
        file, *names = nodeid.split("::")
        scope = ast.parse((ROOT / file).read_text()).body
        for name in names:
            found = [n for n in scope if getattr(n, "name", None) == name]
            assert found, f"{nodeid}: no {name}"
            scope = found[0].body
        assert isinstance(found[0], ast.FunctionDef), nodeid
        assert names[-1].startswith("test_"), nodeid


def test_no_slow_id_tests_the_port():
    for nodeid in _slow_ids():
        file = nodeid.split("::")[0]
        assert not pathlib.Path(file).name.startswith("test_torch_"), nodeid
        todo, seen = [ROOT / file], set()
        while todo:
            path = todo.pop()
            if path in seen:
                continue
            seen.add(path)
            for name in _imported(path):
                assert name.split(".")[0] not in PORT_MODULES, (nodeid, path, name)
                imported = ROOT / (name.replace(".", "/") + ".py")
                if name.startswith("tests.") and imported.is_file():
                    todo.append(imported)
