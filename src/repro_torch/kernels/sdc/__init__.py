"""Symmetric Distance Calculation: the fused scan + top-k kernel."""
