"""The port stands alone: zokrates_tpu_torch and chip_smoke.py import
neither jax nor any module of the JAX package (zokrates_tpu), and importing
them builds nothing and needs no CUDA toolkit.

Checked twice: by importing every module of the package in a fresh
interpreter where running a compiler (subprocess.run) raises, then
reading sys.modules; and by reading every import statement in the
sources.
"""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "zokrates_tpu_torch")


def _modules():
    import zokrates_tpu_torch

    names = ["zokrates_tpu_torch"]
    for info in pkgutil.walk_packages(zokrates_tpu_torch.__path__, "zokrates_tpu_torch."):
        names.append(info.name)
    return names


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, json, subprocess, sys\n"
        "def refuse(*a, **k): raise AssertionError('importing ran ' + repr(a))\n"
        "subprocess.run = subprocess.check_output = subprocess.check_call = refuse\n"
        f"names = {_modules()!r}\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'zokrates_tpu' or m.startswith('zokrates_tpu.'))\n"
        "print(json.dumps({'n': len(names), 'bad': bad}))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["n"] >= 20


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(os.path.relpath(p, ROOT) for p in _sources()))
def test_sources_import_no_jax(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "zokrates_tpu"), (path, node.lineno, n)


def test_walks_cover_the_witness_generator():
    """Both checks reach the levelized witness generator."""
    name = "zokrates_tpu_torch.interp.vectorized"
    assert name in _modules()
    assert name.replace(".", "/") + ".py" in {os.path.relpath(p, ROOT) for p in _sources()}


def test_walks_cover_the_recursion_modules():
    """Both checks reach the in-circuit verifier's modules (embed/) and the
    BW6-761 pairing."""
    new = ["zokrates_tpu_torch.embed.builder", "zokrates_tpu_torch.embed.tower_sym",
           "zokrates_tpu_torch.embed.snark_verify", "zokrates_tpu_torch.ec.pairing_bw6"]
    assert set(new) <= set(_modules())
    paths = {os.path.relpath(p, ROOT) for p in _sources()}
    assert {n.replace(".", "/") + ".py" for n in new} <= paths
