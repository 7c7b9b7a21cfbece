"""File formats of the match graph (numpy and the standard library only)."""
