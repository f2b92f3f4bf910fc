"""Logging and profiling helpers (counterpart of `radvlm_tpu/utils/`'s
`logging_utils.py` and `profiling.py`)."""
