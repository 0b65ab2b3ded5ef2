import os
import sys

# Tests run on the CPU backend with 8 virtual devices, so multi-device
# sharding logic is exercised without accelerators (see SURVEY.md section 4).
# The backend is forced to the CPU (pytest_configure) unless the run selects
# exactly the GPU tests: `python -m pytest -m gpu tests/` on a GPU machine
# leaves it to JAX_PLATFORMS / jax's default.  The GPU path as a whole is
# checked by `python chip_smoke.py`.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU backend; skipped elsewhere")
    if config.getoption("markexpr", "") != "gpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
    if os.environ.get("JAX_PLATFORMS"):
        # a pytest plugin may have imported jax before this was decided
        jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless jax's default backend is a GPU.
    Decided here, per test, never at import or collection time, so every
    xdist worker collects the same tests."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax
        if jax.default_backend() != "gpu":
            pytest.skip(f"needs a GPU backend (have {jax.default_backend()})")


@pytest.fixture(scope="session")
def sim_data(tmp_path_factory):
    """Small simulated dataset shared across the test session."""
    from tools.simulate_reads import generate_dataset
    outdir = tmp_path_factory.mktemp("simdata")
    return generate_dataset(str(outdir), genome_len=200_000, read_len=150,
                            depth=20.0, inserts=(400, 800), seed=7)
