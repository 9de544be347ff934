"""Loss-curve and prediction plotting (reference: data_plot.py:15-107,
comparison.py:72-134, visualization.py:57-123).

Counterpart of `admm_lstm_tpu/utils/plotting.py`: `LossCurvePlotter`,
`plot_comparison` and `plot_predictions`.  matplotlib is imported inside
the drawing functions, never at import time: machines that train on the
card may not have it, and only the drawing step needs it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

from admm_lstm_torch.utils.logging import info

color_list = [
    'b', 'g', 'r', 'c', 'm', 'y', 'k',
    '#FF5733', '#33FF57', '#3357FF', '#8A2BE2', '#D2691E', '#FF1493',
]


def _pyplot():
    """matplotlib.pyplot on the Agg backend; ImportError naming --no-plot
    when matplotlib is missing."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError('plotting needs matplotlib, which is not '
                          'installed; rerun with --no-plot') from e
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


class LossCurvePlotter:
    """Accumulate (epoch, loss) points and render/save a curve."""

    def __init__(self, title: str = 'Loss Curve', xlabel: str = 'Epoch',
                 ylabel: str = 'Loss', save_dir: Optional[str] = None,
                 constant_dicts: Optional[Tuple[Dict, Dict]] = None,
                 nu: Optional[float] = None) -> None:
        self.title, self.xlabel, self.ylabel = title, xlabel, ylabel
        self.save_dir = os.path.abspath(save_dir) if save_dir else None
        self.epochs: List[int] = []
        self.losses: List[float] = []
        self.extra_info = constant_dicts if constant_dicts is not None else ({}, {})
        self.nu = nu

    def update(self, epoch: int, loss) -> None:
        self.epochs.append(epoch)
        self.losses.append(float(loss))

    def reset(self) -> None:
        self.epochs, self.losses = [], []

    def plot(self, save_name: Optional[str] = None) -> Optional[str]:
        """Draw the curve; save it under save_dir when both are given.

        Raises ImportError naming the CLI's --no-plot when matplotlib is
        missing."""
        plt = _pyplot()

        fig, ax = plt.subplots(figsize=(10, 6))
        plt.subplots_adjust(right=0.75)
        ax.plot(self.epochs, self.losses, label='Loss', color='blue', marker='o')
        ax.set_title(self.title, fontsize=16)
        ax.set_xlabel(self.xlabel, fontsize=14)
        ax.set_ylabel(self.ylabel, fontsize=14)
        ax.grid(True, linestyle='--', alpha=0.7)
        ax.legend(fontsize=12)

        dict1, dict2 = self.extra_info
        text1 = '\n'.join(f'{k}: {v}' for k, v in dict1.items())
        text2 = '\n'.join(f'{k}: {v}' for k, v in dict2.items())
        side = fig.add_axes((0.8, 0.1, 0.2, 0.8), frame_on=False)
        side.axis('off')
        side.text(0, 0.5, (f'Nu: {self.nu}\n\n' if self.nu is not None else '')
                  + f'Beta Values:\n{text1}\n\nRho Values:\n{text2}',
                  fontsize=12, va='center', ha='left')

        path = None
        if save_name and self.save_dir:
            os.makedirs(self.save_dir, exist_ok=True)
            path = self._dedup_path(save_name)
            plt.savefig(path, dpi=150)
            info(f'Plot saved to {path}')
        plt.close(fig)
        return path

    def _dedup_path(self, name: str) -> str:
        if not name.endswith(('.png', '.jpg')):
            name += '.png'
        path = os.path.join(self.save_dir, name)
        if os.path.isfile(path):
            stem, ext = path[:-4], path[-3:]
            i = 1
            while os.path.isfile(f'{stem}_{i}.{ext}'):
                i += 1
            path = f'{stem}_{i}.{ext}'
        return path


def plot_comparison(loss_list: Sequence[Dict], num_epochs: int,
                    save_dir: str = 'plots', with_initial: bool = False,
                    symlog_linthresh: float = 0.01) -> List[str]:
    """Overlay the train and validation loss curves of several optimizers
    (reference: comparison.py:72-134; a symlog y-axis, one figure per
    split).  Returns the two saved paths."""
    plt = _pyplot()
    os.makedirs(save_dir, exist_ok=True)
    epochs = list(range(num_epochs + 1))
    paths = []
    for split, fname in (('train_loss', 'ComparisonTrainingLoss.png'),
                         ('val_loss', 'ComparisonValidationLoss.png')):
        fig = plt.figure(figsize=(20, 5))
        xs = epochs if with_initial else epochs[1:]
        for i, method in enumerate(loss_list):
            ys = method[split] if with_initial else method[split][1:]
            plt.plot(xs, ys, color=color_list[i % len(color_list)],
                     linestyle='-', marker='o', label=method['name'])
        plt.xlabel('Epochs')
        plt.ylabel('Loss')
        plt.legend(loc='upper right', frameon=True, edgecolor='black',
                   facecolor='white', framealpha=1.0, fancybox=True)
        plt.grid(True)
        plt.yscale('symlog', linthresh=symlog_linthresh)
        plt.xlim([0 if with_initial else 1, num_epochs])
        path = os.path.join(save_dir, fname)
        plt.savefig(path, dpi=150, bbox_inches='tight')
        plt.close(fig)
        info(f'Comparison plot saved to {path}')
        paths.append(path)
    return paths


def plot_predictions(named_predictions: Dict[str, 'object'], truth,
                     save_dir: str = 'plots',
                     save_name: str = 'Predictions.png') -> str:
    """Overlay model predictions vs ground truth on the test set
    (reference: visualization.py:57-123).  Returns the saved path.

    Raises ImportError naming --no-plot when matplotlib is missing."""
    import numpy as np
    plt = _pyplot()
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, save_name)
    fig = plt.figure(figsize=(16, 5))
    truth = np.asarray(truth).reshape(-1)
    plt.plot(truth, color='black', linewidth=2, label='Ground truth')
    for i, (name, pred) in enumerate(named_predictions.items()):
        plt.plot(np.asarray(pred).reshape(-1),
                 color=color_list[i % len(color_list)], alpha=0.8, label=name)
    plt.xlabel('Sample')
    plt.ylabel('Value')
    plt.legend(loc='upper right')
    plt.grid(True, alpha=0.5)
    plt.savefig(path, dpi=150, bbox_inches='tight')
    plt.close(fig)
    info(f'Prediction plot saved to {path}')
    return path
