"""Closed-form and prox-linear subproblem solvers."""
