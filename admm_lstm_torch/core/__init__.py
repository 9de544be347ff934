"""The ADMM state, its initialization, the epoch and its residuals."""
