"""Cluster wire formats (so far only the TENSOR delta codec)."""
