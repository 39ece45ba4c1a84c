"""Lattice ops on tensors and the CUDA kernel launches."""
