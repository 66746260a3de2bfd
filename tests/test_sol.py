"""Unit tests for the sweep work models (utils/sol.py): the FLOP/byte
models are pure functions -- check structure and scaling."""

from dpilqr_tpu.utils import sol


def test_backward_flop_model_scales_cubically_in_width():
    # Doubling K multiplies the dominant nuf^2(nuf+nxf) / nuf*nxf^2 terms
    # by ~8; the model should sit between quadratic and cubic growth.
    f1 = sol.backward_step_flops(4, 4, 2)
    f2 = sol.backward_step_flops(8, 4, 2)
    assert 4 * f1 < f2 < 16 * f1


def test_hbm_byte_model_counts_streams_only():
    b = sol.backward_step_hbm_bytes(8, 4, 2)
    nxf, nuf = 32, 16
    expected = (
        8 * 4 * 4 + 8 * 4 * 2 + nuf * nuf + nxf * nxf + nxf + nuf
        + nuf * nxf + nuf
    ) * 4
    assert b == expected


def test_forward_flop_model_scales_with_alphas():
    f10 = sol.forward_step_flops(8, 4, 2, 10, 5)
    f2 = sol.forward_step_flops(8, 4, 2, 2, 5)
    # Rollout work is per line-search candidate.
    assert f10 > 4 * f2


def test_pscan_flops_model():
    assert sol.pscan_sweep_flops(100, 32) == 2 * 100 * 11 * 2 * 32**3


def test_forward_trig_model():
    # 4 dynamics evals per substep, 2 transcendentals per slot column.
    assert sol.forward_step_trig_ops(8, 4, 2, 10, 5) == 5 * 4 * 2 * 8 * 10
