"""Spectral estimators of the port."""
