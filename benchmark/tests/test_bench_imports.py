"""What the harness and the reference load: never JAX nor the JAX package
(compared by whole top-level names, since the port's name begins with the
JAX package's), and the reference never the program."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "genie_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted("
                          "{m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0",
                              "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_program():
    names = _loaded("import benchmark.reference.nn, benchmark.reference.domain, "
                    "benchmark.reference.pipeline, benchmark.reference.train")
    assert not names & (FORBIDDEN | {"genie_tpu_torch"})


def test_a_run_loads_no_jax():
    code = ("from benchmark.tests.cpu_cell import run_small\n"
            "run_small('nc_run6_updated.sweep')\n"
            "import benchmark.run, benchmark.harness.check, benchmark.harness.system\n")
    names = _loaded(code)
    assert "genie_tpu_torch" in names
    assert not names & FORBIDDEN


def test_a_training_run_loads_no_jax():
    """The training cell's entry (``benchmark/entries/train.py``) loads the
    program's trainer, generator and workflow, and no JAX."""
    code = ("from benchmark.tests.cpu_cell import run_small_train\n"
            "run_small_train()\n")
    names = _loaded(code)
    assert "genie_tpu_torch" in names
    assert not names & FORBIDDEN
