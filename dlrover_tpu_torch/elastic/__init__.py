"""Elastic training: the sampler and dataloader that resume mid-epoch at
any world size, a fixed global batch across world-size changes, fault
injection and the live ZeRO reshard (port of ``dlrover_tpu/elastic``)."""
