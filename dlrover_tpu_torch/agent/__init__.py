"""Port of ``dlrover_tpu.agent``: the master client, the master-driven
rendezvous, the per-host elastic agent and its launcher."""
