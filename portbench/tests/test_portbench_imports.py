"""Nothing the benchmark runs imports ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``repro``, compared by whole top-level name, and nothing
reads ``benchmarks/``."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench.runtime import forbidden_modules

HERE = Path(__file__).resolve().parents[1]


def test_top_level_names_compared_whole():
    mods = {"repro_torch": 1, "repro_torch.models": 1, "reproduce": 1,
            "jaxtyping": 1, "torch": 1}
    assert forbidden_modules(mods) == []
    mods.update({"repro": 1, "repro.core.plan": 1, "jax.numpy": 1,
                 "jaxlib": 1, "flax.linen": 1})
    assert forbidden_modules(mods) == ["flax.linen", "jax.numpy", "jaxlib",
                                       "repro", "repro.core.plan"]


def test_sources_import_no_jax_and_read_no_benchmarks():
    for path in HERE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in (
                    "jax", "jaxlib", "flax", "repro", "benchmarks"), \
                    (path, n)
        if "tests" not in path.parts:
            assert "benchmarks/" not in path.read_text(), path


def test_harness_loads_no_jax():
    """Every module of the harness and of the program it drives, imported
    in a fresh process, loads nothing of JAX."""
    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "import portbench.drivers.prefill\n"
        "import portbench.drivers.a2a, portbench.reference.model\n"
        "import repro_torch.models\n"
        "import repro_torch.core.cache, repro_torch.models.moe\n"
        "from portbench.runtime import forbidden_modules\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
