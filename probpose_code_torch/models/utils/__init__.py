"""Model building blocks shared by heads."""
