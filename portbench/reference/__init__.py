"""The plain reference the output check holds the program to: plain PyTorch
and NumPy, importing nothing of the program."""
