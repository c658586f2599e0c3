"""Generators, one a module, each named by a traffic mix."""
