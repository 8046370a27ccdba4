"""The plain reference that decides `correct`: plain PyTorch, no kernel and
nothing of the program (nets.py, weights.py, train.py)."""
