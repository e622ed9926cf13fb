"""What the runner, the drivers and the reference load: never JAX, flax or
the JAX package (top-level names compared whole, so `centerpose_tpu_torch`
is not `centerpose_tpu`), and the reference nothing of the port either."""

import json
import subprocess
import sys

import pytest

from posebench import harness

PROBE = """
import json, sys
for name in {modules!r}:
    __import__(name)
{extra}
print(json.dumps(sorted({{m.split('.', 1)[0] for m in sys.modules}})))
"""


def loaded(modules, extra=""):
    out = subprocess.run([sys.executable, "-c", PROBE.format(modules=modules, extra=extra)],
                         capture_output=True, text=True, check=True, cwd=str(harness.ROOT), timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_runner_and_drivers_load_no_jax():
    tops = loaded(["posebench.run", "posebench.readings", "posebench.drivers.serve", "posebench.drivers.train",
                   "centerpose_tpu_torch.inference.detector", "centerpose_tpu_torch.training.trainer"])
    assert not tops & {"jax", "jaxlib", "flax", "centerpose_tpu"}
    assert "centerpose_tpu_torch" in tops


@pytest.mark.parametrize("module", ["posebench.reference.net", "posebench.reference.serve",
                                    "posebench.reference.train", "posebench.reference.precision",
                                    "posebench.reference.pnp", "posebench.reference.decode",
                                    "posebench.reference.dcn"])
def test_reference_loads_nothing_of_the_port(module):
    tops = loaded([module])
    assert not tops & {"jax", "jaxlib", "flax", "centerpose_tpu", "centerpose_tpu_torch"}


def test_forbidden_is_whole_name():
    code = ("import sys, types; from posebench.run import loaded_forbidden\n"
            "sys.modules['centerpose_tpu_torch.fake'] = types.ModuleType('f'); assert loaded_forbidden() == []\n"
            "sys.modules['jax.fake'] = types.ModuleType('j'); assert loaded_forbidden() == ['jax']\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(harness.ROOT), timeout=300)
