"""The plain side of the benchmark's model plug-ins (``lib/cell.py``)."""
