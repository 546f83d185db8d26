"""The port reproduces the JAX package's golden artifacts.

Every ``netlib:``/``synthetic:``/``file:`` golden in ``tests/golden/`` was
written by the JAX package.  Its spec, read back through the bridge, must
give the same result dict under the port's ``serial`` backend and under
its ``torch`` backend on the CPU (the plain version of the CUDA kernel).
The same specs run on the card in ``chip_smoke.py``.  Tolerance: exact
dict equality.
"""

import json

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from test_golden_workloads import (  # noqa: E402
    CASES,
    WORKLOADS,
    canonical_dict,
    golden_path,
    golden_spec,
)

from repro_torch.api import run  # noqa: E402
from repro_torch.bridge import spec_from_reference  # noqa: E402

PORT_CASES = [(w, s) for w, s in CASES if not WORKLOADS[w].startswith("tpu:")]


def test_port_cases_are_the_eight_non_tpu_goldens():
    assert len(PORT_CASES) == 8


@pytest.mark.parametrize("backend", ["serial", "torch"])
@pytest.mark.parametrize("workload_key,strategy", PORT_CASES)
def test_port_reproduces_golden(workload_key, strategy, backend):
    golden = json.loads(golden_path(workload_key, strategy).read_text())
    # the reference's spec as JSON (file: carries the machine-local path);
    # canonical_dict canonicalizes the path as the reference's suite does
    spec = spec_from_reference(golden_spec(workload_key, strategy).to_json())
    res = run(spec, eval_backend=backend, device="cpu")
    assert canonical_dict(res) == golden
