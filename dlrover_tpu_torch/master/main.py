"""Standalone job-master entry point.

Port of ``dlrover_tpu/master/main.py``. Run one per job; it prints the
address agents connect to (``--master-addr``) as the JAX one does, and
logs the port of its metrics endpoint (``/metrics``, ``/json``):

    python -m dlrover_tpu_torch.master.main --port 7000 --num-workers 2
    # DLROVER_TPU_MASTER_ADDR=localhost:7000
    # ... metrics endpoint on port 41235

``--max-workers`` above ``--num-workers`` declares an elastic range: the
master's auto-scaler plans the worker count in it, from its local
heuristic or, with ``--optimize-mode cluster --brain-addr host:port``,
from a shared Brain (``python -m dlrover_tpu_torch.cluster.brain``).
"""

import argparse
import sys
from typing import List, Optional

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.master.master import DistributedJobMaster

logger = get_logger(__name__)


def parse_master_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="dlrover-tpu-torch-master")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--num-workers", type=int, default=1)
    p.add_argument("--max-workers", type=int, default=0)
    p.add_argument("--node-unit", type=int, default=1)
    p.add_argument("--job-name", default="job")
    p.add_argument("--job-kind", default="")
    p.add_argument(
        "--optimize-mode",
        default="single-job",
        choices=["single-job", "cluster"],
        help="cluster = resource plans from a shared Brain",
    )
    p.add_argument(
        "--brain-addr",
        default="",
        help="host:port of the Brain service (optimize-mode=cluster)",
    )
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> str:
    master = DistributedJobMaster(
        port=args.port,
        num_workers=args.num_workers,
        max_workers=args.max_workers or args.num_workers,
        node_unit=args.node_unit,
        optimize_mode=args.optimize_mode,
        brain_addr=args.brain_addr,
        job_name=args.job_name,
        job_kind=args.job_kind,
    )
    master.prepare()
    # print the bound address for launchers/operators to scrape
    print(f"DLROVER_TPU_MASTER_ADDR={master.addr}", flush=True)
    return master.run()


def main(argv: Optional[List[str]] = None) -> int:
    reason = run(parse_master_args(argv))
    return 0 if reason == "succeeded" else 1


if __name__ == "__main__":
    sys.exit(main())
