"""Port of ``dlrover_tpu.observability``."""
