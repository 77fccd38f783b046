"""Plain PyTorch references, one module a configuration. They import
nothing of the program: each works its answers out again from the inputs
that the benchmark made."""
