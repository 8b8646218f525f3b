"""Published architecture configurations."""
