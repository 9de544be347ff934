"""Checkpoint/resume of the full ADMM state and final-model artifacts."""

from admm_lstm_torch.ckpt.checkpoint import (CheckpointManager, load_model,
                                             save_model)

__all__ = ['CheckpointManager', 'save_model', 'load_model']
