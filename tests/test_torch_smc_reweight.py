"""SMC on the hierarchical target under "reweight" with the cross-fitted
path switch, against the JAX package's run: the cut, the gates and their
measured margins are those of `tests/test_torch_smc_runs.py`."""
from test_torch_smc_runs import compare_runs, one_thread, problem  # noqa: F401


def test_reweight_cross_fit_matches_jax(problem):  # noqa: F811
    compare_runs(problem, "reweight_cross_fit")
