"""The plain reference of the benchmark's configurations and the checks
that hold the program's outputs to it. Imports nothing of the program."""
