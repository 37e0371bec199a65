"""Measurement scripts for the port's kernels, run on the machine with the card."""
