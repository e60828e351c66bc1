"""Synthetic datasets for the port's tests and chip smoke run."""
