"""Utility APIs of the port: ``metrics`` and ``tracing``."""
