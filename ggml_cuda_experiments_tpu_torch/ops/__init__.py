"""Kernel wrappers of the port. Importing a module builds nothing: kernels
compile at their first launch (``ops/_build.py``)."""
