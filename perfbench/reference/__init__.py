"""Plain references: straightforward PyTorch of the same mathematics,
importing nothing of the program, and the comparisons that decide
``correct``."""
