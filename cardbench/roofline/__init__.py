"""The yardstick of the drain kernels: the bytes a drain batch needs and
the card's peak rates (drains.py)."""
