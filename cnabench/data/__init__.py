"""Inputs the benchmark makes from its seed, the same for the program and
the reference."""
