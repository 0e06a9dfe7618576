"""The import rule of the port: no file of `src/tpuflows_torch/` and not
`chip_smoke.py` imports JAX, optax, chex or the JAX package `tpuflows`
(the machine with the card has no JAX)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "tpuflows_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "optax", "chex", "tpuflows")


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


def test_the_port_has_files_to_check():
    assert len(FILES) > 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imported(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_rule_catches_the_jax_package():
    assert _forbidden("tpuflows.flows") and _forbidden("jax.numpy")
    assert not _forbidden("tpuflows_torch.flows")
