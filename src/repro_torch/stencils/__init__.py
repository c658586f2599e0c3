"""Test data for the stencil suite."""
