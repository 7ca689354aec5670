"""Benchmark CLIs with the reference log format."""
