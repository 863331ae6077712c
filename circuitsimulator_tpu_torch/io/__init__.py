"""Output: DC tables and the transient CSV."""
