"""Batching, config, logging and node-address helpers."""
