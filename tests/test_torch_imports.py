"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``."""

import ast
import os
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_files_found():
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(f, REPO) for f in FILES])
def test_no_jax_and_no_reference_package(path):
    for name in _imported(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), (
            f"{path.relative_to(REPO)} imports {name}")
