"""Splitting work over processes."""
