"""Lowering: parsed circuit -> topology + parameter tensors."""
