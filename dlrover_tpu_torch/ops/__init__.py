"""Port of ``dlrover_tpu.ops``."""
