"""The benchmark harness of lvae_tpu_torch: one run of one cell (run.py)."""
