"""Dataset meta-information."""
