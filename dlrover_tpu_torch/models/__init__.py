"""Port of ``dlrover_tpu.models``."""
