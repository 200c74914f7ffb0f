"""Functional evaluation helpers."""
