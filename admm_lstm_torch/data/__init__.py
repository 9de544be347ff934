"""Dataset loaders (numpy), served through `load_dataset`."""

from admm_lstm_torch.data.registry import load_dataset, supported_datasets

__all__ = ['load_dataset', 'supported_datasets']
