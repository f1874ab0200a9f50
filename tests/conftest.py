"""Test config.

The tier-1 suite runs on the CPU (`JAX_PLATFORMS=cpu`). Tests marked
`gpu` need a CUDA card, because they run compiled Pallas kernels, which
have no CPU form; they skip elsewhere. Whether a card is present is
decided at run time in a fixture, never at import or collection time.
On the card: `python -m pytest -m gpu tests/` (chip_smoke.py runs them).

NOTE: never set --xla_force_host_platform_device_count here — carving
the host into 8 virtual devices cripples XLA:CPU for every test.
Multi-device mesh coverage lives in tests/test_multichip.py, which
re-execs itself in a subprocess with the flag set.
"""
import os

import pytest

os.environ.setdefault("JAX_ENABLE_X64", "0")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.default_backend() != "gpu":
            pytest.skip("needs a CUDA GPU: runs a compiled Pallas kernel")
