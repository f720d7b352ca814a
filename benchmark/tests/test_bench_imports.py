"""Nothing under benchmark/ imports JAX or the JAX package, compared by
whole top-level module name, and no reference imports the program."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "sonido_sonar_tpu"}


def _top_levels(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(BENCH)): sorted(set(_top_levels(p)) & FORBIDDEN)
             for p in BENCH.rglob("*.py")}
    assert {k: v for k, v in found.items() if v} == {}
    assert len(found) > 20  # the scan saw the harness


def test_references_import_nothing_of_the_program():
    refs = sorted((BENCH / "reference").glob("*.py"))
    assert refs
    for p in refs:
        assert "sonido_sonar_tpu_torch" not in set(_top_levels(p)), p.name


def test_top_level_comparison_is_whole_names():
    # the port's name begins with the JAX package's: only a whole match counts
    assert "sonido_sonar_tpu_torch".split(".")[0] not in FORBIDDEN
    from benchmark import run

    assert "sonido_sonar_tpu" in run.BANNED and "sonido_sonar_tpu_torch" not in run.BANNED
