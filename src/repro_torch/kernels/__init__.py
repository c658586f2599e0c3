"""The port's kernels: hand-written CUDA for Hopper, each beside its plain
PyTorch version, plus the tap engine and the oracle they share."""
