"""The plain reference the benchmark judges the program against.

Plain PyTorch and NumPy: it imports nothing of the program under test
and takes nothing the program made; it reads the configuration file and
regenerates the random streams the program was handed.
"""
