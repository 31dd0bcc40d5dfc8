"""The port stands alone: raw_ngp_torch and chip_smoke.py import neither
JAX nor the JAX package raw_ngp_tpu (not even its jax-free modules).

Checked two ways: a fresh interpreter imports every module of the port
plus chip_smoke and must end with neither in ``sys.modules``; and the
sources are scanned for import statements naming either.
"""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import raw_ngp_torch
for m in pkgutil.walk_packages(raw_ngp_torch.__path__, "raw_ngp_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "raw_ngp_tpu"))
print("LEAKED:" + ",".join(bad))
"""


def test_import_leaves_jax_and_reference_unloaded():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    line = [l for l in out.stdout.splitlines() if l.startswith("LEAKED:")]
    assert line == ["LEAKED:"], out.stdout


_IMPORT = re.compile(
    r"^\s*(?:from\s+(jax|jaxlib|raw_ngp_tpu)\b|import\s+(?:[\w.]+\s*,\s*)*"
    r"(jax|jaxlib|raw_ngp_tpu)\b)", re.M)


def test_sources_name_no_jax_import():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "raw_ngp_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 10
    offenders = []
    for path in files:
        with open(path) as f:
            src = f.read()
        offenders += [f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}"
                      for m in _IMPORT.finditer(src)]
    assert not offenders, offenders
