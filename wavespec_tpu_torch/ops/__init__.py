"""Numerical building blocks of the port."""
