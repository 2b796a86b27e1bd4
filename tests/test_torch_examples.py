"""The port's examples (``examples/torch_*.py``) run end to end on the CPU
at their smallest size, each in a subprocess with ``--device cpu``, and
import the port only (never ``jax`` or ``repro``)."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = {
    "torch_quickstart.py": (["--genome-kb", "2"], "longest polished contig"),
    # the smallest run that still finds overlaps (R and S not empty)
    "torch_assemble_genome.py": (["--genome-kb", "2", "--depth", "8", "--out",
                                  "{tmp}/c.fasta"], "[out]"),
    "torch_serve_decode.py": (["--gen", "8"], "sample row"),
    "torch_train_lm.py": (["--steps", "20", "--seq", "32", "--ckpt-dir",
                           "{tmp}/ckpt"], "over 20 steps"),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    path = os.path.join(ROOT, "examples", name)
    with open(path) as f:
        src = f.read()
    assert not re.search(r"^\s*(import|from)\s+(jax|repro)\b", src, re.M)
    argv, marker = EXAMPLES[name]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, path, "--device", "cpu",
         *(a.format(tmp=tmp_path) for a in argv)],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert marker in proc.stdout, proc.stdout[-3000:]
