"""Frozen plain reference: see the header of each module."""
