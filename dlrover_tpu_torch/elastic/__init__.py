"""Elastic training: fixed global batch across world-size changes, fault
injection and the live ZeRO reshard (port of ``dlrover_tpu/elastic``;
its sampler and dataloader wait for ROADMAP A11's rest)."""
