"""Sharding rules: the reference's partition specs as data over a ``LeafMesh``."""
