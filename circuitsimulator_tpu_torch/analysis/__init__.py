"""DC operating point and Backward-Euler transient."""
