"""Serving for the port's LM substrate: the continuous-batching engine."""
