"""Multi-view geometry: the two-view bootstrap and what it calls."""
