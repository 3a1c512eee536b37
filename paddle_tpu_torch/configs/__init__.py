"""Book configs of the port, loaded by path by
``python -m paddle_tpu_torch train <config.py>``."""
