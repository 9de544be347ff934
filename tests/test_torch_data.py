"""The port's numpy data loaders give exactly the JAX package's arrays."""

import numpy as np
import pytest

from admm_lstm_tpu.data import load_dataset as j_load_dataset
from admm_lstm_torch.data import load_dataset


@pytest.mark.parametrize('name,kw', [('GoogleStock', {}),
                                     ('Synthetic', {}),
                                     ('Synthetic', dict(batch=37, seq_len=4,
                                                        input_size=3,
                                                        output_size=2,
                                                        seed=5))])
def test_torch_load_dataset_matches_jax(name, kw):
    arrays, ps, title = load_dataset(name, **kw)
    j_arrays, j_ps, j_title = j_load_dataset(name, **kw)
    assert title == j_title
    assert ps.as_dict() == j_ps.as_dict()
    for a, b in zip(arrays, j_arrays):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_torch_googlestock_shapes_and_clipping():
    (tx, ty, vx, vy), _, _ = load_dataset('GoogleStock', 100, 7)
    assert tx.shape == (100, 10, 1) and ty.shape == (100, 1)
    assert vx.shape == (7, 10, 1) and vy.shape == (7, 1)


@pytest.mark.parametrize('name', ['YahooFinance', 'HAR', 'NoSuchSet'])
def test_torch_unported_datasets_raise(name):
    with pytest.raises(ValueError, match='not yet ported' if name != 'NoSuchSet'
                       else 'not supported'):
        load_dataset(name)
