"""Recursive filters of the v7.57 tail: biquad band-pass and Kalman 4D."""
