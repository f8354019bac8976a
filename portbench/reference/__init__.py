"""The plain reference the benchmark holds the program's results to.
It imports nothing of the program."""
