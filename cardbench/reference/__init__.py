"""Plain NumPy references of the data types the benchmark serves, each
computed from the deltas the peers sent. They import nothing of the
program, of JAX or of the JAX package."""
