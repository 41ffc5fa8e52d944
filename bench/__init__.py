"""The benchmark of the PyTorch and CUDA port: ``python3 bench/run.py``."""
