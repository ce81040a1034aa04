"""Numerical-health guards, fault injection and the serving layer's
residual check."""
