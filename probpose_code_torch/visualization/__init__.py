"""The runner's scalar-logging backends."""

from .vis_backends import LocalVisBackend, build_vis_backends  # noqa: F401
