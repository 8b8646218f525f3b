"""Step builders (serving steps so far; training comes with its slice)."""
