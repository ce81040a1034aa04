"""Linear solvers."""
