"""Non-linear least squares."""
