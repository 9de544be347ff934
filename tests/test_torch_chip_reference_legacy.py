"""The JAX package's reference numbers that chip_smoke.py's `legacy` phase
holds the card to, recomputed with the JAX package on the CPU.  The chip
machine has no JAX, so chip_smoke.py reads them from
tests/golden/torch_legacy_reference.npz (LEGACY_REF); this test keeps that
file equal to what the JAX package computes.  Regenerate it with

    python tests/test_torch_chip_reference_legacy.py
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

# f32 on another CPU may round a few last bits differently.
RTOL = 1e-5


def compute_reference():
    """Every number of the file, from the JAX package on GoogleStock at
    the CLI's width (H 10, seed 0):
      * admm_l_{train,val}: admm_l_demo, LEGACY_EPOCHS epochs;
      * best_{variant}_{choice,probe_names,probe_val}: train_best with
        LEGACY_BEST_ARGS;
      * {method}_{train,val}: train_grad_based at DEFAULT_LRS for
        GRAD_EPOCHS epochs from the golden seed-0 weights w0_*."""
    import jax
    jax.config.update('jax_platforms', 'cpu')
    from admm_lstm_tpu import ADMMConfig
    from admm_lstm_tpu import api
    from admm_lstm_tpu.data import load_dataset
    from admm_lstm_tpu.models.lstm import params_from_dict
    from admm_lstm_tpu.utils.logging import set_console_enabled
    from admm_lstm_tpu.variants.admm_l import admm_l_demo
    from admm_lstm_tpu.variants.grad_based import train_grad_based
    set_console_enabled(False)
    (tx, ty, vx, vy), ps, _ = load_dataset('GoogleStock')
    out = {}
    res = admm_l_demo(chip_smoke.LEGACY_EPOCHS, 10, tx, ty, vx, vy, seed=0,
                      log_every=0)
    out['admm_l_train'], out['admm_l_val'] = (res['train_loss'],
                                              res['val_loss'])
    args = chip_smoke.LEGACY_BEST_ARGS
    for variant in ('admm_l', 'admm_s'):
        res = api.train_best(tx, ty, vx, vy, ps,
                             ADMMConfig(variant=variant, hidden_size=10,
                                        epochs=args['epochs']),
                             probe_epochs=args['probe_epochs'], log_every=0)
        out[f'best_{variant}_choice'] = res['preset_choice']
        out[f'best_{variant}_probe_names'] = list(res['probe_val'])
        out[f'best_{variant}_probe_val'] = list(res['probe_val'].values())
    g = np.load(chip_smoke.GOLDEN)
    params = params_from_dict({k[3:]: g[k] for k in g.files
                               if k.startswith('w0_')})
    for method in ('sgd', 'adam', 'adagrad'):
        res = train_grad_based(method, tx, ty, vx, vy,
                               chip_smoke.GRAD_EPOCHS, params=params)
        out[f'{method}_train'], out[f'{method}_val'] = (res['train_loss'],
                                                        res['val_loss'])
    return {k: np.asarray(v) for k, v in out.items()}


def test_torch_chip_reference_legacy():
    want = compute_reference()
    with np.load(chip_smoke.LEGACY_REF) as f:
        got = {k: f[k] for k in f.files}
    assert got.keys() == want.keys()
    for k, v in want.items():
        if v.dtype.kind in 'fc':
            np.testing.assert_allclose(got[k], v, rtol=RTOL, err_msg=k)
        else:
            assert got[k].tolist() == v.tolist(), k


if __name__ == '__main__':
    np.savez(chip_smoke.LEGACY_REF, **compute_reference())
    print(f'wrote {chip_smoke.LEGACY_REF}')
