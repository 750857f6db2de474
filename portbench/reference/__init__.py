"""The plain reference that decides a run's ``correct``: plain PyTorch in
float32, importing nothing of the program under test or of the JAX package."""
