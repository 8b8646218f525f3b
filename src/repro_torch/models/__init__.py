"""Models of the reference's zoo, ported one slice at a time."""
