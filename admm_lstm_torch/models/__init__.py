"""The LSTM-Linear model."""
