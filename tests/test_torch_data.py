"""The port's numpy data loaders give exactly the JAX package's arrays."""

import csv
import os

import numpy as np
import pytest

from admm_lstm_tpu.data import gefcom_wind as j_gefcom_wind
from admm_lstm_tpu.data import load_dataset as j_load_dataset
from admm_lstm_tpu.data import synthetic as j_synthetic
from admm_lstm_tpu.data import yahoo_finance as j_yahoo_finance
from admm_lstm_torch.data import gefcom_wind, load_dataset, synthetic
from admm_lstm_torch.data import yahoo_finance


def _equal(arrays, j_arrays):
    assert len(arrays) == len(j_arrays)
    for a, b in zip(arrays, j_arrays):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('name,kw', [('GoogleStock', {}),
                                     ('Synthetic', {}),
                                     ('Synthetic', dict(batch=37, seq_len=4,
                                                        input_size=3,
                                                        output_size=2,
                                                        seed=5)),
                                     ('YahooFinance', {}),
                                     ('DNA1', {}),
                                     ('DNA1', dict(seed=3)),
                                     ('DNA1', dict(torch_shuffle=False)),
                                     ('SMSSpam', {}),
                                     ('GEFCOM2012Wind', {}),
                                     ('GEFCOM2012Wind', dict(farm=7,
                                                             window=12))])
def test_torch_load_dataset_matches_jax(name, kw):
    arrays, ps, title = load_dataset(name, **kw)
    j_arrays, j_ps, j_title = j_load_dataset(name, **kw)
    assert title == j_title
    assert ps.as_dict() == j_ps.as_dict()
    _equal(arrays, j_arrays)


@pytest.mark.parametrize('which', ['yahoo_scenarios', 'yahoo_series',
                                   'wind_scenarios', 'hierarchical'])
def test_torch_scenarios_and_hierarchical_match_jax(which):
    if which == 'yahoo_scenarios':
        got = yahoo_finance.load_scenarios(num_scenarios=3, seed=2)
        ref = j_yahoo_finance.load_scenarios(num_scenarios=3, seed=2)
    elif which == 'yahoo_series':
        rng = np.random.default_rng(0)
        series = [np.cumsum(rng.standard_normal(n)) + 50 for n in (90, 100)]
        got = yahoo_finance.load_scenarios(series=series)
        ref = j_yahoo_finance.load_scenarios(series=series)
    elif which == 'wind_scenarios':
        got = gefcom_wind.load_scenarios(num_train=64, num_val=16)
        ref = j_gefcom_wind.load_scenarios(num_train=64, num_val=16)
    else:
        got = synthetic.load_hierarchical(batch=40, seq_len=6, val_batch=9)
        ref = j_synthetic.load_hierarchical(batch=40, seq_len=6, val_batch=9)
    _equal(got, ref)


def test_torch_googlestock_shapes_and_clipping():
    (tx, ty, vx, vy), _, _ = load_dataset('GoogleStock', 100, 7)
    assert tx.shape == (100, 10, 1) and ty.shape == (100, 1)
    assert vx.shape == (7, 10, 1) and vy.shape == (7, 1)


def test_torch_dna1_leaves_the_global_rng_alone():
    import torch
    torch.manual_seed(123)
    want = torch.rand(3)
    torch.manual_seed(123)
    load_dataset('DNA1')
    assert torch.equal(torch.rand(3), want)


@pytest.mark.parametrize('name', ['YahooFinance', 'HAR', 'NoSuchSet'])
def test_torch_unported_datasets_raise(name, tmp_path):
    """Every name of the JAX registry is served now: YahooFinance loads,
    HAR without its raw files raises FileNotFoundError as the JAX package
    does, an unknown name still raises ValueError."""
    if name == 'YahooFinance':
        (tx, ty, vx, vy), _, title = load_dataset(name)
        assert tx.shape == (1360, 60, 1) and vx.shape == (340, 60, 1)
        assert title == 'Yahoo Finance'
    elif name == 'HAR':
        for fn in (load_dataset, j_load_dataset):
            with pytest.raises(FileNotFoundError, match='HAR'):
                fn(name)
        with pytest.raises(FileNotFoundError, match='HAR'):
            load_dataset(name, path=str(tmp_path))
    else:
        with pytest.raises(ValueError, match='not supported'):
            load_dataset(name)


@pytest.mark.parametrize('name', ['PTB', 'UCF101', 'MNISTDataset'])
def test_torch_removed_datasets_raise_like_jax(name):
    with pytest.raises(ValueError) as got:
        load_dataset(name)
    with pytest.raises(ValueError) as ref:
        j_load_dataset(name)
    assert str(got.value) == str(ref.value)


def test_torch_registry_serves_the_jax_names():
    from admm_lstm_tpu.data.registry import removed_datasets as j_removed
    from admm_lstm_tpu.data.registry import supported_datasets as j_names
    from admm_lstm_torch.data.registry import (removed_datasets,
                                               supported_datasets)
    assert supported_datasets == j_names and removed_datasets == j_removed


def test_torch_gefcom2012_missing_file_raises(tmp_path):
    for fn in (load_dataset, j_load_dataset):
        with pytest.raises(FileNotFoundError, match='GEFCOM2012'):
            fn('GEFCOM2012')
    with pytest.raises(FileNotFoundError, match='GEFCOM2012'):
        load_dataset('GEFCOM2012', path=str(tmp_path))


def _write_har(root):
    """Three segments: 12x act1, 5x act2 (dropped: < window), 20x act3;
    the test split lacks class 3."""
    for split, labels in (('train', [1] * 12 + [2] * 5 + [3] * 20),
                          ('test', [2] * 11 + [1] * 14)):
        n = len(labels)
        feats = np.arange(n * 4, dtype=np.float64).reshape(n, 4) / 10.0
        np.savetxt(root / f'X_{split}.txt', feats, fmt='%.6e')
        np.savetxt(root / f'y_{split}.txt', np.asarray(labels), fmt='%d')


def _write_load_history(root, n_days=8):
    load_dir = root / 'Load'
    load_dir.mkdir(parents=True)
    data = np.round(np.random.default_rng(0).uniform(100, 1000,
                                                     size=(n_days, 24)), 1)
    with open(load_dir / 'Load_history.csv', 'w', newline='') as f:
        writer = csv.writer(f)
        writer.writerow(['zone_id', 'year', 'month', 'day']
                        + [f'h{i}' for i in range(1, 25)])
        for day in range(n_days):
            writer.writerow([1, 2004, 1, day + 1]
                            + [f'{v:,.1f}' for v in data[day] * 10])


@pytest.mark.parametrize('name,kw', [
    ('HAR', {}), ('HAR', dict(minimal_window=5)),
    ('GEFCOM2012', dict(train_days=(1, 3), val_days=(4, 6))),
    ('GEFCOM2012', dict(train_days=(2, 4), val_days=(5, 9)))])
def test_torch_raw_file_datasets_match_jax(tmp_path, name, kw):
    """HAR and GEFCOM2012 from files the test writes (the raw files are not
    in the repository), through `path`, as the CLI's --data_dir passes
    it."""
    if name == 'HAR':
        _write_har(tmp_path)
    else:
        _write_load_history(tmp_path)
    arrays, ps, title = load_dataset(name, path=str(tmp_path), **kw)
    j_arrays, j_ps, j_title = j_load_dataset(name, path=str(tmp_path), **kw)
    assert title == j_title and ps.as_dict() == j_ps.as_dict()
    _equal(arrays, j_arrays)
    assert arrays[0].shape[0] > 0 and arrays[2].shape[0] > 0
