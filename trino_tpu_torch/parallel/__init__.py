"""Fragment execution shared by the out-of-core tier (``runner.py``)."""
