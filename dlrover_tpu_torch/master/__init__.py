"""Port of ``dlrover_tpu.master``: the job master of the elastic
control plane (node lifecycle, rendezvous, KV store, sync barriers,
speed monitor) behind the two-RPC transport."""
