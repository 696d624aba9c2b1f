"""Port of ``dlrover_tpu.serving``."""
