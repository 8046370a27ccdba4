"""The control on the card at a size a test run holds: the plain reference
computed with TF32 on (the precision below the float32 the configurations
state) in the program's place reads as not correct against the cell's
limits. benchmark/control.py reads it at the cells' own sizes."""
import math

import pytest

import control
from harness.spec import Spec

SERVING = ['qarv_base.dec.kodak-b8', 'qres34m.dec.kodak-b8',
           'qarv_base.enc.kodak-b8']


@pytest.mark.cuda
@pytest.mark.parametrize('cell', SERVING)
def test_serving_control_fails(card, cell):
    spec = Spec(cell)
    spec.traffic = dict(spec.traffic, check_sample=2, per_lambda=1)
    out = control.serving_control(spec, 2 ** 31 + 101, card)
    assert out['differ_gap'] > spec.limits['differ_gap']


@pytest.mark.cuda
def test_training_control_fails(card):
    spec = Spec('qarv_base.train.b16-c256')
    spec.traffic = dict(spec.traffic, batch=4)
    out = control.training_control(spec, 2 ** 31 + 102, card, 5)
    assert set(out) == set(spec.limits)
    assert all(math.isfinite(v) for v in out.values())
    assert any(out[k] > spec.limits[k] for k in out)
