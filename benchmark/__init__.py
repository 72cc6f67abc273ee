"""The port's benchmark (see benchmark/run.py)."""
