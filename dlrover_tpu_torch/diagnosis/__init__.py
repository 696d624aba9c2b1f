"""Failure diagnosis on the master (port of ``dlrover_tpu.diagnosis``)."""
