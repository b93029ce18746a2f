"""The plain reference: PyTorch written from the published method,
importing nothing of the program."""
