"""The worker task API (``worker.py``)."""
