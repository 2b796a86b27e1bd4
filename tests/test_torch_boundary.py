"""Boundaries of the port: it imports neither JAX nor the JAX package; it
never carries on on the CPU when the card was asked for; a kernel wrapper
launches or raises and never falls back; and it stays clean under the
repository's static analysis."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import (
    cc_rounds,
    kmer_pack,
    minplus_matmul,
    pileup_vote,
    spgemm_masked_minplus,
    xdrop_extend_batch,
)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value.split(".")[0]


def test_port_imports_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(REPO)), root) for f in files
           for root in _imported_roots(f) if root in FORBIDDEN]
    assert bad == []


def _run(code: str):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, cwd=str(REPO))


def test_default_device_raises_without_cuda():
    code = (
        "import numpy as np\n"
        "from repro_torch.assembly.pipeline import assemble\n"
        "assemble(np.zeros((2, 40), np.uint8), np.full(2, 40, np.int32))\n"
    )
    r = _run(code)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr


def test_port_import_pulls_in_no_jax():
    r = _run("import sys, repro_torch.assembly.pipeline, repro_torch.convert\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'repro'))\n"
             "print(bad)\n")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


@pytest.mark.parametrize("which", ["xdrop", "minplus", "pileup", "cc",
                                   "spgemm_masked", "kmer_pack"])
def test_kernel_wrapper_raises_on_non_cpu_request(which):
    """Tensors that are not on the CPU go to the kernel or raise: here they
    lie on the ``meta`` device, which no kernel takes."""
    m = {"device": "meta"}
    u8 = dict(dtype=torch.uint8, **m)
    i32 = dict(dtype=torch.int32, **m)
    with pytest.raises(ValueError, match="CUDA tensor"):
        if which == "xdrop":
            xdrop_extend_batch(torch.empty(4, 9, **u8), *(torch.empty(4, **i32),) * 3,
                               torch.empty(4, 9, **u8), *(torch.empty(4, **i32),) * 3)
        elif which == "minplus":
            a = torch.empty(8, 8, 4, dtype=torch.float32, **m)
            minplus_matmul(a, a)
        elif which == "spgemm_masked":
            c = torch.empty(8, 4, **i32)
            v = torch.empty(8, 4, 4, dtype=torch.float32, **m)
            spgemm_masked_minplus(c, v, c, v, c)
        elif which == "kmer_pack":
            kmer_pack(torch.empty(4, 40, **u8), torch.empty(4, **i32), k=15)
        elif which == "cc":
            cc_rounds(torch.empty(4, 2, **i32), torch.empty(4, 1, **i32),
                      torch.empty(4, **i32), 8)
        else:
            pileup_vote(torch.empty(1, 10, **u8), torch.empty(1, 2, 10, **u8),
                        torch.empty(1, 2, **i32), torch.empty(1, 2, **i32))


def test_kernel_build_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the build runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kbuild.build_all(["xdrop"])
    k = kbuild.CudaKernel("xdrop", [])
    with pytest.raises(RuntimeError):
        k.launch()
    assert k.launches == 0


def test_port_passes_static_analysis():
    r = subprocess.run(
        [sys.executable, "-m", "repro.analysis", "check", "src/repro_torch"],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
    )
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    assert "analysis clean" in r.stdout
