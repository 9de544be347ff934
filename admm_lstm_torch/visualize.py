"""Prediction visualization over saved models.

Counterpart of `admm_lstm_tpu/visualize.py` (reference parity:
comparison_experiment/visualization.py): load every model artifact in
SAVED_MODELS/, run inference on a dataset's test split, and overlay the
predictions against the ground truth in plots/Predictions.png.

Run: python -m admm_lstm_torch.visualize [-d GoogleStock]
         [--save_dir SAVED_MODELS] [--cpu] [--no-plot]

It runs on the CUDA card unless --cpu is given, and exits non-zero with
neither.  The figure needs matplotlib; --no-plot logs each model's test
MSE instead (the JAX package's visualize has no such flag).  As in the JAX package, `predict_all` runs the one-layer
`lstm_forward` on every loaded model, so a stacked model's file
(l0_* keys) fails there.
"""

from __future__ import annotations

import glob
import os
import sys
import zipfile
from typing import Dict

import numpy as np
import torch

from admm_lstm_torch.ckpt.checkpoint import load_model
from admm_lstm_torch.models.lstm import LSTMParams, lstm_forward
from admm_lstm_torch.utils.device import NoCudaDeviceError, resolve_device
from admm_lstm_torch.utils.logging import ADMMError, error, info, warning


def load_models(save_dir: str = 'SAVED_MODELS',
                device='cuda') -> Dict[str, LSTMParams]:
    """Load all saved model artifacts onto `device`
    (visualization.py:47-54); a file that does not load is reported and
    skipped."""
    device = resolve_device(device)
    models: Dict[str, LSTMParams] = {}
    for path in sorted(glob.glob(os.path.join(save_dir, '*.npz'))):
        name = os.path.splitext(os.path.basename(path))[0]
        try:
            models[name] = load_model(path, device=device)
        except (OSError, KeyError, ValueError, zipfile.BadZipFile) as e:
            warning(f'Cannot load {path}: {e}')
    info(f'Loaded {len(models)} model(s) from {save_dir}.')
    return models


def predict_all(models: Dict[str, LSTMParams],
                test_x) -> Dict[str, np.ndarray]:
    """Run every model on the test inputs (B, T, I) on its own device
    (visualization.py:102-109); (B, O) numpy predictions."""
    out = {}
    with torch.no_grad():
        for name, params in models.items():
            x = torch.as_tensor(np.asarray(test_x, np.float32),
                                device=params.wy.device)
            out[name] = lstm_forward(params, x).cpu().numpy()
    return out


def plot_all(predictions: Dict[str, np.ndarray], test_y,
             save_dir: str = 'plots') -> str:
    from admm_lstm_torch.utils.plotting import plot_predictions
    return plot_predictions(predictions, test_y, save_dir=save_dir)


def main(argv=None) -> int:
    import argparse
    from admm_lstm_torch.data import load_dataset, supported_datasets
    parser = argparse.ArgumentParser(prog='admm-lstm-torch-visualize')
    parser.add_argument('--dataset', '-d', default='GoogleStock',
                        choices=supported_datasets)
    parser.add_argument('--save_dir', default='SAVED_MODELS')
    parser.add_argument('--cpu', action='store_true',
                        help='Run on the CPU (the default is the CUDA card)')
    parser.add_argument('--no-plot', dest='plot', action='store_false',
                        help="Log each model's test MSE instead of plotting")
    args = parser.parse_args(argv)
    try:
        try:
            device = resolve_device('cpu' if args.cpu else 'cuda')
        except NoCudaDeviceError as e:
            error(f'{e}.')
        (_, _, test_x, test_y), _, _ = load_dataset(args.dataset)
        models = load_models(args.save_dir, device=device)
        if not models:
            warning('No saved models found; train with --save first.')
            return 1
        predictions = predict_all(models, test_x)
        if not args.plot:
            for name, pred in predictions.items():
                mse = float(np.mean((pred - np.asarray(test_y)) ** 2))
                info(f'{name}: test MSE {mse:.8f}')
            return 0
        try:
            plot_all(predictions, test_y)
        except ImportError as e:
            error(str(e))
        return 0
    except ADMMError as e:
        return e.code


if __name__ == '__main__':
    sys.exit(main())
