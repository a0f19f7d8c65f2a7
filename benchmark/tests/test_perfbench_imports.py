"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole), and the reference and the roofline counts import
nothing of the program."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_top_level_names_are_whole(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import volq_torch.engine\nfrom jaxlib import x\n"
                 "import volq.oracle as o\nfrom . import y\n"
                 "importlib.import_module('jax.numpy')\n")
    assert top_imports(p) == {"volq_torch", "jaxlib", "volq", "jax"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not top_imports(path) & {"jax", "jaxlib", "flax", "volq"}


@pytest.mark.parametrize("path", [p for p in FILES if "reference" in p.parts
                                  or p.name == "roofline.py"],
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_and_counts_import_nothing_of_the_program(path):
    assert "volq_torch" not in top_imports(path)
