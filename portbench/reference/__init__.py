"""The frozen plain reference the benchmark holds the program against
(plain PyTorch; imports nothing of the measured program)."""
