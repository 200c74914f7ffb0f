"""Codec utilities."""
