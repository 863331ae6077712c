"""DC operating point, Backward-Euler transient and AC small-signal
analysis."""
