"""The operation and byte counts and the window's arithmetic against
values worked out by hand."""

from types import SimpleNamespace

import pytest

from portbench import flops, readers, roofline


def test_epoch_ops_prox_linear_by_hand():
    # B 4, Bv 2, T 3, I 2, H 1, O 1: N = 12, K = 4.
    s = {'B': 4, 'val': 2, 'T': 3, 'I': 2, 'H': 1, 'O': 1}
    n, k = 12, 4
    expect = (2 * 2 * 1 * 1 * 4                    # wy
              + 2 * n * 2 * k + 2 * n * 1 * k      # projections
              + 4 * n * 2 * k                      # x stage
              + 4 * n * 1 * k                      # h stage
              + 2 * n * 2 * k + 2 * n * 1 * k      # sweep products
              + 4 * 2 * 1 * 1 * 4                  # final h
              + 2 * 18 * 3 * k + 2 * 1 * 1 * 6)    # losses
    assert flops.epoch_ops(s) == expect == 1644


def test_epoch_ops_exact_by_hand():
    s = {'B': 4, 'val': 2, 'T': 3, 'I': 2, 'H': 1, 'O': 1}
    n, k = 12, 4
    gram_x = n * k * 2 * 3 + 2 * n * 2 * k + 2 * k * 4 + k * (8 / 3 + 8)
    gram_h = n * k * 1 * 2 + 2 * n * 1 * k + 2 * k * 1 + k * (1 / 3 + 2)
    expect = (16 + 2 * n * 2 * k + 2 * n * 1 * k + gram_x + 2 * n * 2 * k
              + gram_h + 2 * n * 2 * k + 2 * n * 1 * k + 32 + 2 * 18 * 3 * k
              + 12)
    assert flops.epoch_ops(s, exact_max_dim=8) == pytest.approx(expect)
    # Only stages no wider than the limit are exact.
    part = flops.epoch_ops(s, exact_max_dim=1)
    assert part == pytest.approx(expect - gram_x - 2 * n * 2 * k
                                 + 4 * n * 2 * k)


def test_a_wide_exact_epoch_is_mostly_its_symmetric_gram():
    # UCI HAR's 561 features and 6 classes at H 128, B 2048.
    s = {'B': 2048, 'val': 128, 'T': 10, 'I': 561, 'H': 128, 'O': 6}
    ops = flops.epoch_ops(s, exact_max_dim=1024)
    gram = 20480 * 512 * 561 * 562
    assert 3.5e12 < ops < 3.7e12 and gram / ops > 0.9


def test_sweep_bounds_by_hand():
    # (9, 10, 4224): bytes 4 (380160 * 25 + 400 + 6) = 38017624 over
    # 3.35e12; operations 380160 * 185 = 70329600 over 67e12.
    t, by = roofline.sweep_bound(9, 10, 4224)
    assert by == 'bytes' and t == pytest.approx(38017624 / 3.35e12)
    t27, _ = roofline.sweep_bound(9, 10, 4224, cands=27)
    assert t27 == pytest.approx(27 * t)
    t, by = roofline.jacobi_bound(9, 128, 2048)
    assert by == 'bytes' and t == pytest.approx(
        4 * (9 * 128 * 2048 * 26 + 6) / 3.35e12)


def test_cholesky_bounds_by_hand():
    # (512, 128): operations 512 (128^3 / 3 + 2 * 128^2) against bytes
    # 4 * 512 * (8256 + 256).
    t, by = roofline.solve_bound(512, 128)
    assert by == 'operations'
    assert t == pytest.approx(512 * (128 ** 3 / 3 + 2 * 128 ** 2) / 67e12)
    t, by = roofline.inverse_bound(512, 64)
    assert t == pytest.approx(max(4 * 512 * (2080 + 4096) / 3.35e12,
                                  512 * 2 * 64 ** 3 / 3 / 67e12))


def _ctx(times, start=100.0):
    """Jobs back to back from `start`, each of `times` seconds."""
    jobs, t = [], start
    for d in times:
        jobs.append(SimpleNamespace(start=t, end=t + d, epochs=30,
                                    cand_epochs=30 * 27))
        t += d
    return SimpleNamespace(jobs=jobs, window_start=start)


def test_rate_and_tail_with_a_stall():
    # 19 jobs of 0.5 s and one stalled job of 5 s.
    times = [0.5] * 10 + [5.0] + [0.5] * 9
    ctx = _ctx(times)
    assert readers.rate(ctx, 'epochs') == pytest.approx(600 / 14.5)
    assert readers.rate(ctx, 'cand_epochs') == pytest.approx(16200 / 14.5)
    # Nearest rank: the 18th of 20 sorted times is still 0.5 s; the
    # 20th (p100) is the stall.
    assert readers.percentile_ms(ctx, 90) == pytest.approx(500.0)
    assert readers.percentile_ms(ctx, 100) == pytest.approx(5000.0)
    ctx = _ctx([0.5] * 8 + [5.0, 6.0])
    assert readers.percentile_ms(ctx, 90) == pytest.approx(5000.0)


def test_percentile_of_one_hundred_runs():
    ctx = _ctx([0.001 * (i + 1) for i in range(100)])
    assert readers.percentile_ms(ctx, 90) == pytest.approx(90.0)
    assert readers.percentile_ms(_ctx([]), 90) is None


def test_idle_share_takes_the_unprofiled_wall():
    # Two unprofiled jobs of 30 epochs in 0.4 s and 0.2 s: 10 ms an epoch.
    # The profiled jobs' 60 epochs kept the device busy 0.15 s, 2.5 ms an
    # epoch, in a profiled wall of 1.2 s that the idle share ignores.
    ctx = _ctx([0.4, 0.2])
    ctx.traced_jobs = [SimpleNamespace(epochs=30), SimpleNamespace(epochs=30)]
    ctx.trace = SimpleNamespace(busy_s=0.15, window_s=1.2)
    assert readers.idle_share(ctx) == pytest.approx(75.0)
    ctx.trace = None
    assert readers.idle_share(ctx) is None


def test_weight_gap_is_taken_on_the_change():
    import torch

    from portbench import check
    w0 = (torch.ones(4, 2, 3), torch.ones(4, 3, 3), torch.ones(3, 1))
    moves = (0.01, 0.02, 0.001)
    ref = tuple(w + m for w, m in zip(w0, moves))
    refr = {'weights': ref, 'initial': w0}
    # A state that never moves reads 1 on the leaves at or above the
    # median change.
    assert check.weight_gap({'weights': w0}, refr) == pytest.approx(1.0)
    # wh off by 1% of its change: 1% of its own norm of the change.
    prog = (ref[0], ref[1] + 0.0002, ref[2])
    assert check.weight_gap({'weights': prog}, refr) == pytest.approx(
        0.01, rel=1e-3)
    # wy's change is under the median's (wx's), which scales its gap.
    prog = (ref[0], ref[1], ref[2] + 0.001)
    assert check.weight_gap({'weights': prog}, refr) == pytest.approx(
        (3 * 1e-6) ** 0.5 / (24 * 1e-4) ** 0.5, rel=1e-3)


def test_early_loss_gap_reads_the_first_epochs_only():
    import numpy as np

    from portbench import check
    n = check.EARLY_EPOCHS + 1
    refr = {'train': np.linspace(1.0, 2.0, 31), 'val': np.ones(31)}
    prog = {'train': refr['train'].copy(), 'val': refr['val'].copy()}
    prog['train'][n:] *= 1.5         # the later epochs part
    assert check.early_loss_gap(prog, refr) == 0.0
    assert check.loss_gap(prog, refr) == pytest.approx(0.5)
    prog['val'][n - 1] = 1.01        # the last early epoch
    assert check.early_loss_gap(prog, refr) == pytest.approx(0.01)
