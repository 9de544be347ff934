"""The port's configuration layer matches the JAX package's."""

import dataclasses

import pytest

from admm_lstm_tpu import params as j_params
from admm_lstm_tpu.utils import config as jc
from admm_lstm_torch import params as t_params
from admm_lstm_torch.utils import config as tc


@pytest.mark.parametrize('name', sorted(j_params.example_parameter_dictionary))
def test_torch_parameter_set_matches_jax(name):
    assert t_params.parameter_set(name).as_dict() == \
        j_params.parameter_set(name).as_dict()


def test_torch_parameter_tables_match():
    assert sorted(t_params.example_parameter_dictionary) == \
        sorted(j_params.example_parameter_dictionary)
    assert t_params.default_epoch == j_params.default_epoch


def test_torch_config_fields_and_presets_match():
    def as_dict(cfg):
        return dataclasses.asdict(cfg)
    assert as_dict(tc.ADMMConfig()) == as_dict(jc.ADMMConfig())
    assert as_dict(tc.ADMMConfig.turbo()) == as_dict(jc.ADMMConfig.turbo())
    assert as_dict(tc.ADMMConfig.auto()) == as_dict(jc.ADMMConfig.auto())
    assert as_dict(tc.ADMMConfig.auto(hidden_size=32)) == \
        as_dict(jc.ADMMConfig.auto(hidden_size=32))
    assert tc.AUTO_FIELDS == jc.AUTO_FIELDS
    assert tc.VARIANTS == jc.VARIANTS
    assert (tc.GATE_KEYS, tc.RHO_KEYS, tc.BETA_KEYS) == \
        (jc.GATE_KEYS, jc.RHO_KEYS, jc.BETA_KEYS)


@pytest.mark.parametrize('kw', [
    dict(variant='nope'),
    dict(variant='no_dual_y', with_dual_y=True),
    dict(matmul_precision='fast'),
    dict(use_pallas_chol='yes'),
    dict(use_pallas_sweep=2),
    dict(dtype='float16'),
])
def test_torch_config_validation_matches_jax(kw):
    with pytest.raises(ValueError) as j_err:
        jc.ADMMConfig(**kw)
    with pytest.raises(ValueError) as t_err:
        tc.ADMMConfig(**kw)
    assert str(t_err.value) == str(j_err.value)


_RHO = dict(j_params.example_parameter_dictionary['GoogleStock']['rho'])
_BETA = dict(j_params.example_parameter_dictionary['GoogleStock']['beta'])


@pytest.mark.parametrize('rho,beta,exc', [
    ({'i': 1.}, _BETA, ValueError),                 # missing rho keys
    (_RHO, {'wi': 1.}, ValueError),                 # missing beta keys
    ({**_RHO, 'c': -1.}, _BETA, ValueError),        # negative
    ({**_RHO, 'c': 'x'}, _BETA, TypeError),         # not numeric
])
def test_torch_parameter_set_validation_matches_jax(rho, beta, exc):
    with pytest.raises(exc) as j_err:
        jc.ParameterSet(rho=rho, beta=beta)
    with pytest.raises(exc) as t_err:
        tc.ParameterSet(rho=rho, beta=beta)
    assert str(t_err.value) == str(j_err.value)
