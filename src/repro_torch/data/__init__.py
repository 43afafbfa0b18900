"""Data substrate: synthetic Amazon-like review generation."""
