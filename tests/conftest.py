import os
import tempfile
from functools import partial

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
# Hermetic per-run compilation cache: tests compile fresh and never load
# (or leave behind) executables in the checkout's persistent cache, whose
# XLA:CPU entries may have been built for another host CPU.
os.environ["JAX_COMPILATION_CACHE_DIR"] = tempfile.mkdtemp(
    prefix="jax_dpilqr_test_cache_"
)

import jax  # noqa: E402
import pytest  # noqa: E402

import dpilqr_tpu  # noqa: F401, E402  (enables x64)

# Tests run on the CPU backend (8 virtual devices for the sharding tests),
# also on a machine that has a GPU; tests marked ``gpu`` ask for the card
# explicitly through the ``gpu_device`` fixture.
jax.config.update("jax_default_device", jax.devices("cpu")[0])


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Every compiled XLA:CPU executable holds tens-to-hundreds of memory
    mappings; a full suite run accumulates ~60k of them and crosses the
    kernel's vm.max_map_count (65530 here), at which point a LATER compile
    segfaults inside backend_compile_and_load (observed deterministically
    around test #127).  Dropping compiled programs between modules keeps
    the count bounded -- measured 20266 -> 633 for
    tests/test_distributed.py -- at the cost of cross-module recompiles."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: tests marked ``gpu`` need the card (run
    them there with ``python -m pytest -m gpu tests/``)."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (no CUDA device visible to JAX)")


@pytest.fixture
def triton_interpret(monkeypatch):
    """Route the "triton" sweep backend through the Pallas interpreter, so
    solves that resolve to the kernel run on the CPU."""
    from dpilqr_tpu.ops import riccati_triton

    monkeypatch.setattr(
        riccati_triton,
        "backward_pass_triton",
        partial(riccati_triton.backward_pass_triton, interpret=True),
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere"
    )
