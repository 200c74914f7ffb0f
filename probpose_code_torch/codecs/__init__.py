"""Codecs (host side)."""
