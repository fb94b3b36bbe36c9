"""No module of the benchmark loads JAX or the JAX package, and the
plain reference loads nothing of the program, by the top-level name of
each import compared whole."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "isotope_tpu"}
PROGRAM = "isotope_tpu_torch"


def imports(path: pathlib.Path):
    """Top-level names of every import in a module."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def local_closure(path: pathlib.Path):
    """``path`` and every benchmark module it imports, transitively."""
    seen, todo = set(), [path]
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level == 0 and (
                    node.module.split(".")[0] == "portbench"):
                rel = pathlib.Path(*node.module.split(".")[1:])
                for cand in (ROOT / rel.with_suffix(".py"),
                             ROOT / rel / "__init__.py"):
                    if cand.is_file():
                        todo.append(cand)
                for a in node.names:
                    sub = ROOT / rel / f"{a.name}.py"
                    if sub.is_file():
                        todo.append(sub)
    return seen


MODULES = sorted(ROOT.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for p in local_closure(path):
        assert PROGRAM not in imports(p), p
        assert not imports(p) & FORBIDDEN, p


def test_the_check_tells_the_names_apart():
    # the port's name begins with the JAX package's: compared whole
    assert "isotope_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "isotope_tpu.sim".split(".")[0] in FORBIDDEN
