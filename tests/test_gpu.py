"""Checks that need an NVIDIA GPU: chip_smoke.py's phase functions, at
the widths it runs them.  They skip on other platforms; run them on a
machine with a card (one process on the card) with

    JAX_PLATFORMS=cuda python -m pytest tests/test_gpu.py -m gpu
"""

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


def test_flagship_run_keeps_state_invariants():
    assert chip_smoke.phase_a()['capacity'] == chip_smoke.SIZES['C_a']


def test_mixed_families_run_and_match_hp():
    assert set(chip_smoke.phase_b()['hp_rel_err']) >= {'clustering', 'niw'}


def test_resume_is_bitwise_at_scale():
    pytest.importorskip('google.protobuf')
    assert chip_smoke.phase_c()['differing_rows'] == 0


def test_onehot_contraction_at_full_width():
    assert chip_smoke.phase_d()['rel_err'] <= 1e-6
