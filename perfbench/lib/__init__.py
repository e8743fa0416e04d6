"""Shared pieces of the benchmark's harness."""
