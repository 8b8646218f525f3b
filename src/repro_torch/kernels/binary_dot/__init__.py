"""The paper's bitwise baseline: xor + popcount over packed bit planes."""
