"""Test configuration: float64 correctness gates on a virtual 8-device CPU mesh.

The reference's correctness claims are Java-double claims; we validate in
float64 on the CPU backend (SURVEY.md §7 "Hard parts"). The 8 virtual
devices let mesh/sharding logic run without accelerators (SURVEY.md §4).
The platform is pinned through both the environment and jax's config
before jax initializes, so the suite runs on the CPU even on a machine
with a GPU; chip_smoke.py is the GPU check.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_addoption(parser, pluginmanager):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (big filter banks, property sweeps, "
             "multi-process). Default `pytest -q` skips them so the fast "
             "suite stays under ~5 min single-process; CI passes --runslow.",
    )
    if not pluginmanager.hasplugin("xdist"):
        # addopts carries `-n auto`; without pytest-xdist a plain `pytest`
        # run would hard-fail on the unrecognized flag before collecting a
        # single test. conftest pytest_addoption runs before addopts
        # parsing, so registering the flag as an accepted no-op degrades
        # the run to serial instead.
        group = parser.getgroup("xdist", "no-op stand-ins (pytest-xdist absent)")
        # _addoption: same bypass pytest-xdist itself uses to claim the
        # reserved lowercase -n short flag
        group._addoption(
            "-n", "--numprocesses", action="store", default=None,
            help="ignored: pytest-xdist is not installed, running serially",
        )
        group._addoption(
            "--dist", action="store", default=None,
            help="ignored: pytest-xdist is not installed, running serially",
        )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("JWAVE_RUN_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow: enable with --runslow or JWAVE_RUN_SLOW=1")
    for item in items:
        if item.get_closest_marker("slow"):
            item.add_marker(skip)


@pytest.fixture
def rng():
    return np.random.default_rng(42)
