"""The port imports neither JAX nor the JAX package.

Every ``repro_torch`` module and ``chip_smoke.py`` are checked twice: their
import statements (parsed, one case per file), and a fresh interpreter that
imports all of them and must end with no ``jax`` or ``repro`` module loaded.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, name)


def test_importing_the_port_loads_no_jax():
    """A fresh interpreter imports every repro_torch module and
    chip_smoke (without running it): neither jax nor repro is loaded."""
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in PORT_FILES]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
