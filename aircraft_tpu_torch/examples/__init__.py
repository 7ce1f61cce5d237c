"""Runnable studies of the port, one module each (``python -m ...``)."""
