"""Exhaustive indexes."""
