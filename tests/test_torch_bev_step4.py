"""The BEV e2e train step at 4 lanes with the heads (four 3-way line
classifiers and the horizon), the port against the JAX package on the
CPU, with the area loss and with the parameter MSE: the tests, setup and
bars of tests/test_torch_bev_step.py on its 4-lane cases."""

import pytest

from test_torch_bev_step import (  # noqa: F401  (collected here)
    run_bev, test_eval_step_matches_jax, test_metrics_match_jax,
    test_new_running_stats_match_jax, test_train_mode_beta_matches_jax,
    test_whole_gradient_matches_jax)

CASES = [(4, "area"), (4, "mse")]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{n}lanes-{p}" for n, p in CASES])
def case(request):
    return request.param, run_bev(*request.param)
