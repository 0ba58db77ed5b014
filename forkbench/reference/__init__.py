"""The benchmark's plain reference: the two block kinds of its cells, in
plain PyTorch, float32.  It imports nothing of the program under test."""
