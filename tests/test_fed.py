import numpy as np

from akaze_jax.fed import fed_tau_by_process_time

import golden


def test_tau_matches_golden_transliteration():
    for T in (0.53, 1.06, 4.3, 12.0, 34.0, 68.0):
        for reorder in (False, True):
            ours = fed_tau_by_process_time(T, 1, 0.25, reorder)
            ref = golden.fed_tau_by_process_time(T, 1, 0.25, reorder)
            assert len(ours) == len(ref)
            np.testing.assert_allclose(ours, ref, rtol=1e-12)


def test_tau_sum_reaches_process_time():
    for T in (0.5, 2.0, 10.0, 50.0):
        tau = fed_tau_by_process_time(T, 1, 0.25, True)
        # the tau cycle sums to the requested diffusion time
        assert abs(sum(tau) - T) / T < 1e-6


def test_reordering_is_permutation():
    for T in (1.06, 12.0):
        a = sorted(fed_tau_by_process_time(T, 1, 0.25, False))
        b = sorted(fed_tau_by_process_time(T, 1, 0.25, True))
        np.testing.assert_allclose(a, b, rtol=1e-12)


def test_all_taus_below_stability_bound():
    # reordered FED steps exceed tau_max individually but the cycle is
    # stable; unordered first step must be below tau_max
    tau = fed_tau_by_process_time(4.3, 1, 0.25, False)
    assert tau[0] <= 0.25 * 1.0001
    assert max(tau) > 0.25  # FED's point: some steps violate the CFL bound
