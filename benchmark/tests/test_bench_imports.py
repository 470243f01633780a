"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names, compared
whole)."""

import json
import subprocess
import sys

from benchmark.tests.conftest import ROOT

PROBE = """
import json, sys
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def loaded(body):
    p = subprocess.run([sys.executable, "-c", PROBE.format(body=body)],
                       cwd=ROOT, capture_output=True, text=True, timeout=600,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.splitlines()[-1]))


def test_reference_imports_nothing_of_the_program():
    top = loaded("import benchmark.plain.check_train, "
                 "benchmark.plain.check_render, benchmark.plain.faults, "
                 "benchmark.scenes, benchmark.local, benchmark.weights")
    assert not top & {"spurfies_tpu_torch", "spurfies_tpu", "jax", "jaxlib",
                      "flax"}


def test_rehearsal_loads_no_jax():
    top = loaded(
        "from benchmark.tests.conftest import tiny_spec\n"
        "from benchmark import harness\n"
        "harness.run_cell(tiny_spec('own_data.train'), 1, 0.2, False, "
        "'cpu')")
    assert "spurfies_tpu_torch" in top
    assert not top & {"spurfies_tpu", "jax", "jaxlib", "flax"}
