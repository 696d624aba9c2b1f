"""Port of ``dlrover_tpu.common``."""
