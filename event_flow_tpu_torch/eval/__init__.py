"""Evaluation harness of the port."""
