"""The benchmark of the port yaha_tpu_torch (run.py is its command)."""
