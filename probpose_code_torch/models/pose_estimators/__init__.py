"""Pose estimators."""
