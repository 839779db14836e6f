"""The plain reference of the benchmark: frozen copies of the port's plain
path, importing nothing of the port (see model.py)."""
