"""Serving of the port's decoder LMs: prefill, greedy decode."""
