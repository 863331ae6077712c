"""Solver options."""
