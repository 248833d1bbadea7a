"""The tests that leave tier-1: the frozen JAX package's slowest end-to-end runs.

Tier-1 runs ``pytest tests/ -m 'not slow'``. A test enters ``SLOW`` only if
its file is no ``test_torch_*`` file and imports nothing from
``deblur4dgs_tpu_torch``, ``benchmark`` or ``native``; it takes at least
60 s in a whole tier-1 run; it computes rather than waits (no sleep, no
polling, no subprocess); and tier-1's clock needs it gone (the whole
run well inside its limit, no file above 500 s on its one worker), taken
slowest first. ``tests/test_tier1_slow_list.py`` holds the list to the
first rule. The listed tests stay here and run with
``pytest tests/ -m slow``.
"""

import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

# Node ids from the repo root. Seconds: junit time (setup, call and
# teardown) in one whole tier-1 run (-n 6 --dist loadfile, 8 CPU cores).
SLOW = (
    "tests/test_pipeline_fidelity.py::TestFlowLoss::test_exposure_consistency_contributes_gradients",  # 426.4 s
    "tests/test_pipeline_fidelity.py::TestCliTrainE2E::test_synthetic_train_low_through_cli",  # 357.0 s
    "tests/test_tile_sharding.py::TestFullTrainStepSharded::test_step_matches_unsharded",  # 238.6 s
    "tests/test_pipeline_fidelity.py::TestStaticRegBranch::test_reg_branch_runs_and_regularizes",  # 180.8 s
    "tests/test_pwcnet.py::TestNetwork::test_flow_shapes_and_grads",  # 175.0 s
    "tests/test_models.py::TestSceneRender::test_grads_flow_everywhere",  # 166.9 s
    "tests/test_pipeline.py::TestStagedPipeline::test_static_then_dynamic_then_testing",  # 160.4 s
    "tests/test_pipeline_fidelity.py::TestResume::test_kill_and_resume_static_stage",  # 92.7 s
    "tests/test_pipeline_fidelity.py::TestFlowLoss::test_gated_before_start_epoch",  # 78.6 s
)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: end-to-end test of the frozen JAX package, outside tier-1")


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    # tryfirst: mark before `-m` deselects. The id is rebuilt from the
    # repo root, so it does not depend on where pytest was started.
    for item in items:
        rel = item.path.relative_to(ROOT).as_posix()
        if rel + item.nodeid[item.nodeid.index("::"):] in SLOW:
            item.add_marker(pytest.mark.slow)
