"""dlrover_tpu_torch: the PyTorch/CUDA port of ``dlrover_tpu`` for
NVIDIA Hopper (H100).

The JAX package ``dlrover_tpu`` stays beside it as the reference every
ported module is tested against. This package imports ``torch`` and
never ``jax`` or anything of ``dlrover_tpu``: it keeps its own copies
of the pieces it needs. Module names follow the JAX package so a reader
finds the counterpart of each file.

Ported so far: the serving path (``serving.server.GenerationServer`` →
``serving.scheduler`` → ``serving.engine.ServingEngine`` →
``models.decoder.Decoder`` paged decode/prefill →
``ops.paged_attention``, a hand-written CUDA kernel for ``sm_90a``);
training (``train.trainer.Trainer`` → ``train.train_step`` → the flash
attention and fused norm kernels, with Flash Checkpoint); and elastic
training under the master/agent control plane (``agent.launcher`` →
``master`` + ``agent.agent`` → ``train.distributed`` and the trainer in
each worker).
Entry points run on ``device="cuda"`` unless the caller asks for the
CPU; without a card they raise instead of falling back.
"""

# A worker the elastic agent launches gets a SIGUSR2 Python-stack dumper,
# so the agent's StackCollector can diagnose a hang (the agent sets the
# variable; agent/collectors.py).
import os as _os

if _os.environ.get("DLROVER_TPU_STACK_DUMP") == "1":
    try:
        from dlrover_tpu_torch.agent.collectors import StackCollector

        StackCollector.install_in_worker()
    except Exception:  # noqa: BLE001 — diagnosis must never break startup
        pass
del _os
