"""Heads."""
