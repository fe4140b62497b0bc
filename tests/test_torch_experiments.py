"""The port's paper experiments on the CPU, through the ``cuda`` backend's
plain kernel versions: the claims that ``chip_smoke.py`` asserts on the
card hold here too (exp1, 15000 rounds, and exp5_faults, 6000, run only
on the card)."""
import pytest

from repro_torch import experiments as ex


def test_exp2_linear_convergence_without_noise():
    res = ex.exp2_linear(device="cpu")
    for v in ("sgd", "qsgd", "biqsgd"):
        assert res["loss"][v] < 1e-10, (v, res["loss"])
    # artemis's gamma_max is ~10x below biqsgd's: a steady linear decrease
    assert res["loss"]["artemis"] < res["first_loss"]["artemis"] / 10


@pytest.mark.parametrize("exp,low,high", [
    (ex.exp3_memory, "artemis", "biqsgd"),
    (ex.exp4_pp, "pp2", "pp1")])
def test_memory_and_pp2_remove_the_saturation(exp, low, high):
    exc = exp(device="cpu")["excess"]
    assert exc[low] < exc[high], exc


def test_table3_theory_gamma_max_converges():
    res = ex.table3_gamma_max(device="cpu")["variants"]
    for v in ("sgd", "qsgd", "artemis"):
        assert res[v]["converges"], (v, res[v])
        assert res[v]["empirical_over_theory"] >= 1.0


def test_thm3_sparser_compression_saturates_higher():
    res = ex.thm3_variance_lower_bound(device="cpu")
    sat = res["saturation"]
    assert res["monotone"] and sat[0.25] > sat[1.0], sat
    assert sat[0.5] > sat[1.0], sat


def test_fault_matrix_recovers():
    res = ex.fault_matrix(device="cpu")
    for check in ("identity", "scrub", "sentinel", "bitflip"):
        assert res[check], (check, res)
    assert res["gamma_scale"] == 0.5 ** res["rollbacks"]
