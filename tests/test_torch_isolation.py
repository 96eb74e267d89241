"""The port and its card smoke test import neither JAX nor the JAX package nor
cv2: they must run on a machine that has none of them (the card's machine has
no cv2, so the attribute stage decodes and resizes without it)."""
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FOREIGN = ("jax", "warpedganspace_tpu", "cv2")


def test_port_imports_no_jax():
    """Import every module of the port (found by walking the package) and
    ``chip_smoke`` in a fresh interpreter; none of them may pull in ``jax``,
    ``warpedganspace_tpu`` or ``cv2``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import warpedganspace_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "assert len(names) > 20, names\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        f"foreign = {_FOREIGN!r}\n"
        "print(sorted(m for m in sys.modules\n"
        "             if any(m == f or m.startswith(f + '.') for f in foreign)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_port_sources_name_no_foreign_import():
    """No ``import``/``from`` line of the port's sources names the JAX package,
    JAX or cv2: this also catches an import inside a function."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|warpedganspace_tpu|cv2)\b")
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, filenames in os.walk(os.path.join(REPO, "warpedganspace_torch")):
        sources += [os.path.join(dirpath, f) for f in filenames if f.endswith(".py")]
    assert len(sources) > 20
    hits = []
    for path in sources:
        with open(path) as f:
            hits += [f"{os.path.relpath(path, REPO)}:{i}: {line.strip()}"
                     for i, line in enumerate(f, 1) if pattern.match(line)]
    assert not hits, hits
