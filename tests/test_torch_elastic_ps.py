"""The port's sparse-tier version service (``master/elastic_ps.py``)
against the JAX package's, on the CPU.

Mirrors ``tests/test_elastic_ps.py``'s service cases (the key
partitioning there belongs to the sparse tier's workers, ROADMAP A18):
one script of version, server-set and weight calls runs against both
services with the same return values; the node-lifecycle callback drives
both server sets alike; the PS version messages answer through both
servicers alike; a PS registering on a pre-created worker id enters the
set under its PS name in both node managers.
"""

from dataclasses import dataclass

import pytest

from dlrover_tpu.common import messages as jmsgs
from dlrover_tpu.master.elastic_ps import ElasticPsService as JPs
from dlrover_tpu.master.elastic_ps import PsClusterCallback as JCallback
from dlrover_tpu_torch.common import messages as msgs
from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.master.elastic_ps import (
    ElasticPsService,
    PsClusterCallback,
)

SCRIPT = [
    ("get_global_version",), ("bump_global_version",),
    ("set_node_version", 3, 1), ("get_node_version", 3),
    ("get_node_version", 4),
    ("set_servers", ["h0:70", "h1:70"]), ("set_servers", ["h0:70", "h1:70"]),
    ("set_servers", ["h0:70", "h1:70", "h2:70"]), ("get_servers",),
    ("add_server", "h3:70"), ("add_server", "h3:70"), ("add_server", "a:1"),
    ("remove_server", "h0:70"), ("remove_server", "nope"), ("get_servers",),
    ("set_weights", {"h1:70": 0.5, "h2:70": 1.5}),
    ("set_weights", {"h1:70": 0.5, "h2:70": 1.5}), ("get_weights",),
    ("set_weights", None), ("get_weights",), ("get_global_version",),
]


def test_a_script_of_calls_returns_what_jax_returns():
    mine, theirs = ElasticPsService(), JPs()
    for call in SCRIPT:
        name, *args = call
        assert getattr(mine, name)(*args) == getattr(theirs, name)(*args), \
            call
    assert mine.get_global_version() == 8


@dataclass
class FakeNode:
    id: int
    type: str
    name: str = ""


EVENTS = [
    ("on_node_started", 0, NodeType.PS, "ps-a"),
    ("on_node_started", 1, NodeType.PS, "ps-b"),
    ("on_node_started", 5, NodeType.WORKER, "w-0"),   # ignored
    ("on_node_failed", 5, NodeType.WORKER, "w-0"),
    ("on_node_started", 0, NodeType.PS, "ps-a"),      # idempotent
    ("on_node_started", 2, NodeType.PS, ""),          # named ps-2
    ("on_node_failed", 0, NodeType.PS, "ps-a"),
    ("on_node_succeeded", 2, NodeType.PS, ""),
    ("on_node_deleted", 1, NodeType.PS, "ps-b"),
    ("on_node_deleted", 1, NodeType.PS, "ps-b"),
]


def test_the_lifecycle_callback_drives_the_server_set_as_jax():
    out = []
    for svc_cls, cb_cls in ((ElasticPsService, PsClusterCallback),
                            (JPs, JCallback)):
        ps = svc_cls()
        cb = cb_cls(ps)
        trail = []
        for hook, node_id, kind, name in EVENTS:
            getattr(cb, hook)(FakeNode(node_id, kind, name), None)
            trail.append((ps.get_servers(), ps.get_global_version()))
        out.append(trail)
    assert out[0] == out[1]
    assert out[0][5] == (["ps-2", "ps-a", "ps-b"], 3)
    assert out[0][-1] == ([], 6)


REQUESTS = [
    ("r", jmsgs.PsVersionReport(node_id=0, version_type="global")),
    ("g", jmsgs.PsVersionRequest(node_id=0, version_type="global")),
    ("r", jmsgs.PsVersionReport(node_id=7, version_type="node", version=2)),
    ("g", jmsgs.PsVersionRequest(node_id=7, version_type="node")),
    ("g", jmsgs.PsVersionRequest(node_id=8, version_type="node")),
]


@pytest.mark.parametrize("with_service", [True, False])
def test_the_version_messages_answer_as_jax(with_service):
    from dlrover_tpu.master.servicer import MasterServicer as JServicer
    from dlrover_tpu_torch.master.servicer import MasterServicer

    replies = []
    for servicer_cls, ps_cls, codec in (
            (MasterServicer, ElasticPsService, msgs),
            (JServicer, JPs, jmsgs)):
        ps = ps_cls() if with_service else None
        if ps is not None:
            ps.set_servers(["h0", "h1"])
            ps.set_weights({"h0": 0.5})
        servicer = servicer_cls(ps_service=ps)
        got = []
        for method, req in REQUESTS:
            m = codec.deserialize(jmsgs.serialize(req))
            if method == "r":
                got.append(servicer.report(m))
            else:
                got.append(codec.serialize(servicer.get(m)))
        replies.append(got)
    assert replies[0] == replies[1]
    if with_service:
        resp = msgs.deserialize(replies[0][1])
        assert (resp.version, resp.servers, resp.weights) == (
            3, ["h0", "h1"], {"h0": 0.5})


def test_a_ps_on_a_precreated_id_joins_under_its_ps_name():
    from dlrover_tpu.common.messages import NodeMeta as JMeta
    from dlrover_tpu.master.node_manager import JobManager as JManager
    from dlrover_tpu_torch.common.messages import NodeMeta
    from dlrover_tpu_torch.master.node_manager import JobManager

    out = []
    for manager, meta, svc, cb in (
            (JobManager, NodeMeta, ElasticPsService, PsClusterCallback),
            (JManager, JMeta, JPs, JCallback)):
        jm = manager(num_workers=2)
        ps = svc()
        jm.event_callbacks.append(cb(ps))
        node = jm.register_node(meta(node_id=1, node_type=NodeType.PS))
        out.append((node.type, node.name, ps.get_servers(),
                    ps.get_global_version()))
    assert out[0] == out[1] == (NodeType.PS, "ps-1", ["ps-1"], 1)
