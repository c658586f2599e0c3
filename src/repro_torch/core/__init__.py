"""Spec layer, §5 roofline and §6 planner of the port (pure Python)."""
