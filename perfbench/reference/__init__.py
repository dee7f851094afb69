"""The plain reference (PyTorch and NumPy; nothing of the program) and the comparison that decides ``correct``."""
