"""The comparison that decides ``correct``, on the CPU at test widths: the
reference agrees with the port, the control (the reference in TF32 and
bf16) fails the cells' limits, and a run whose timed path is broken
underneath comes out not correct.

Each test drives ``harness.run_cell`` as a run does, with the look for a
card left out (the program runs its plain kernels on the CPU)."""

import time

import pytest
import torch

from bench_port import calibrate, harness
from bench_port.tests import tiny

CPU = torch.device('cpu')
EVAL_CELLS = {'lifusion_eval_b8': 'epnet_lifusion_f32', 'lidar_eval_b8': 'epnet_lidar_f32'}
# how far the port's plain CPU path and the reference may part at test
# widths: summation orders (read: eval gaps <= 2.5e-6, the first train
# step's loss <= 3.2e-7)
AGREE = {'rpn_gap': 1e-5, 'roi_gap': 1e-5, 'rcnn_gap': 1e-5, 'det_gap': 1e-5,
         'first_loss_gap': 1e-5}
TRAIN_CHECKS = {'first_loss_gap', 'grad_gap', 'delta_median_gap', 'roi_gap'}


def _eval_traffic():
    return tiny.traffic('eval_b8', batch=2, distinct_batches=2, sample_from=3, check_requests=2)


def _train_traffic():
    return tiny.traffic('train_b4', batch=2, distinct_batches=4)


def _run(cell, config, traffic, seed, limits=None):
    return harness.run_cell(cell, tiny.config_file(config), traffic, seed, 0.5, False, CPU,
                            time.perf_counter(), {}, harness.cell_limits(cell)
                            if limits is None else limits)


def _values(out):
    return {k: c['value'] for k, c in out['checks'].items()}


@pytest.mark.parametrize('cell', sorted(EVAL_CELLS))
@pytest.mark.parametrize('seed', [3, 2 ** 31 + 17])
def test_reference_agrees_with_the_port_eval(cell, seed):
    got = _values(_run(cell, EVAL_CELLS[cell], _eval_traffic(), seed))
    assert set(got) == {'rpn_gap', 'roi_gap', 'rcnn_gap', 'det_gap'}
    assert all(v <= AGREE[k] for k, v in got.items()), got


@pytest.mark.parametrize('seed', [5, 2 ** 31 + 99])
def test_reference_agrees_with_the_port_train(seed):
    got = _values(_run('lifusion_train_b4', 'epnet_lifusion_f32', _train_traffic(), seed))
    assert set(got) == TRAIN_CHECKS
    assert got['first_loss_gap'] <= AGREE['first_loss_gap'], got
    assert got['roi_gap'] <= AGREE['roi_gap'], got
    # a leaf's gradient at test widths sums few rows, so one ReLU or max
    # flip moves it more than at the cell's widths: the cell's own limits
    limits = harness.cell_limits('lifusion_train_b4')
    assert got['grad_gap'] <= limits['grad_gap'], got
    assert got['delta_median_gap'] <= limits['delta_median_gap'], got


def _fails_a_limit(readings, cell):
    limits = harness.cell_limits(cell)
    return [k for k, lim in limits.items() if readings[k] > lim]


@pytest.mark.parametrize('cell', sorted(EVAL_CELLS) + ['lifusion_train_b4'])
def test_control_fails_the_limits(cell):
    """Three seeds: the control fails at least one of the cell's limits on
    each (on the card at the cell's own size: ``calibrate.py``)."""
    config = EVAL_CELLS.get(cell, 'epnet_lifusion_f32')
    traffic = _eval_traffic() if cell in EVAL_CELLS else _train_traffic()
    for seed in (101, 102, 2 ** 31 + 103):
        readings = calibrate.control_readings(tiny.config_file(config), traffic, seed, CPU)
        assert _fails_a_limit(readings, cell), (seed, readings)


@pytest.mark.parametrize('fault', ['altered_box', 'half_batch_rpn'])
@pytest.mark.parametrize('cell', sorted(EVAL_CELLS))
def test_a_broken_eval_path_is_not_correct(cell, fault, monkeypatch):
    calibrate.FAULTS[fault](monkeypatch.setattr)
    out = _run(cell, EVAL_CELLS[cell], _eval_traffic(), 7)
    assert out['correct'] is False, out['checks']


@pytest.mark.parametrize('fault', ['state_unchanged', 'half_batch_step'])
def test_a_broken_train_step_is_not_correct(fault, monkeypatch):
    calibrate.FAULTS[fault](monkeypatch.setattr)
    out = _run('lifusion_train_b4', 'epnet_lifusion_f32', _train_traffic(), 7)
    assert out['correct'] is False, out['checks']
