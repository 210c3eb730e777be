"""Generators of the traffic kinds, one module each, found by name."""
