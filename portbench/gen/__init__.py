"""Input generators: plain PyTorch, seeded, on the device they are given.
Both the program and the reference receive what these make."""
