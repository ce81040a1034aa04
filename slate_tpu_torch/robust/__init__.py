"""Numerical-health guards."""
