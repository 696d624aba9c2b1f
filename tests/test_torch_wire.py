"""The port's control-plane wire against the JAX package's, on the CPU.

- every message the port registers (what its control plane sends)
  encodes to the same bytes as the JAX package's message of the same
  name and fields, and decodes back equal, in both packages (hypothesis
  over the field values); the port's one extension field
  (``JoinRendezvousRequest.coordinator_port``) is left out at its
  default, and decodes in the port when set;
- the transport (length-prefixed frames over TCP, no grpc) does report
  and get round trips, retries a refused call on the JAX package's
  jittered backoff schedule, answers a failing get with an error, and
  answers a message type whose master handler is not ported with the
  text naming its ROADMAP item, which the client raises as
  ``NotImplementedError``;
- a JAX-encoded tuning, parallel-config, PS version or Brain message is
  answered by the port's master as the JAX master answers it;
- every request type the JAX servicer handles is either handled by the
  port's or named in its ``UNPORTED`` table.
"""

import dataclasses
import json
import random
import typing

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dlrover_tpu.common import comm as jcomm  # noqa: E402
from dlrover_tpu.common import messages as jmsgs  # noqa: E402
from dlrover_tpu.master.servicer import MasterServicer as JServicer  # noqa
from dlrover_tpu_torch.common import comm, messages as msgs  # noqa: E402
from dlrover_tpu_torch.master.kv_store import KVStoreService  # noqa: E402
from dlrover_tpu_torch.master.servicer import (  # noqa: E402
    UNPORTED,
    MasterServicer,
)

_INT = st.integers(-(2 ** 40), 2 ** 40)
_TEXT = st.text(max_size=12)
_FLOAT = st.floats(allow_nan=False, allow_infinity=False, width=64)


def _strategy(tp):
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if tp is int:
        return _INT
    if tp is float:
        return _FLOAT
    if tp is str:
        return _TEXT
    if tp is bool:
        return st.booleans()
    if origin is typing.Union:  # Optional[X]
        inner = [a for a in args if a is not type(None)][0]
        return st.none() | _strategy(inner)
    if origin in (list, typing.List):
        return st.lists(_strategy(args[0]), max_size=3)
    if origin in (dict, typing.Dict):
        return st.dictionaries(_TEXT, _strategy(args[1]), max_size=3)
    if dataclasses.is_dataclass(tp):
        return _message(tp)
    raise TypeError(tp)


def _message(cls):
    hints = typing.get_type_hints(cls)
    fields = {f.name: _strategy(hints[f.name])
              for f in dataclasses.fields(cls)
              if not f.metadata.get("ext")}
    return st.builds(cls, **fields)


def _jax_twin(value):
    """The JAX package's message with the same fields (recursively)."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        cls = jmsgs._REGISTRY[type(value).__name__]
        return cls(**{f.name: _jax_twin(getattr(value, f.name))
                      for f in dataclasses.fields(value)
                      if not f.metadata.get("ext")})
    if isinstance(value, list):
        return [_jax_twin(v) for v in value]
    if isinstance(value, dict):
        return {k: _jax_twin(v) for k, v in value.items()}
    return value


PORT_MESSAGES = sorted(msgs._REGISTRY)


def test_the_port_registers_only_messages_of_the_jax_package():
    assert set(PORT_MESSAGES) <= set(jmsgs._REGISTRY)
    for name in PORT_MESSAGES:
        mine = [f.name for f in dataclasses.fields(msgs._REGISTRY[name])
                if not f.metadata.get("ext")]
        theirs = [f.name for f in dataclasses.fields(jmsgs._REGISTRY[name])]
        assert mine == theirs, name


@pytest.mark.parametrize("name", PORT_MESSAGES)
@settings(max_examples=25, deadline=None)
@given(data=st.data())
def test_every_message_encodes_as_the_jax_package_does(name, data):
    msg = data.draw(_message(msgs._REGISTRY[name]))
    raw = msgs.serialize(msg)
    assert raw == jmsgs.serialize(_jax_twin(msg))
    assert msgs.deserialize(raw) == msg
    assert jmsgs.deserialize(raw) == _jax_twin(msg)


def test_the_join_sends_its_store_port_only_when_it_has_one():
    plain = msgs.JoinRendezvousRequest(node_id=3, node_rank=1)
    assert msgs.serialize(plain) == jmsgs.serialize(
        jmsgs.JoinRendezvousRequest(node_id=3, node_rank=1))
    picked = msgs.JoinRendezvousRequest(node_id=3, node_rank=1,
                                        coordinator_port=29511)
    raw = msgs.serialize(picked)
    assert b'"coordinator_port": 29511' in raw
    assert msgs.deserialize(raw) == picked


class _Stub:
    """A servicer answering a few types; one handler raises."""

    def __init__(self):
        self.kv = KVStoreService()
        self.reports = []

    def report(self, m):
        self.reports.append(m)
        if isinstance(m, msgs.KeyValuePair):
            self.kv.set(m.key, m.value)
        return True

    def get(self, m):
        if isinstance(m, msgs.KeyRequest):
            if m.key == "boom":
                raise ValueError("boom")
            return msgs.KeyValuePair(key=m.key, value=self.kv.get(m.key))
        return None

    unported = staticmethod(MasterServicer.unported)


@pytest.fixture()
def server():
    stub = _Stub()
    srv = comm.MasterTransportServer(stub, port=0)
    srv.start()
    yield srv, stub
    srv.stop()


def test_report_and_get_round_trip(server):
    srv, stub = server
    client = comm.MasterTransportClient(f"localhost:{srv.port}", retries=2)
    assert client.report(msgs.KeyValuePair(key="a", value="1"))
    assert client.get(msgs.KeyRequest(key="a")) == msgs.KeyValuePair(
        key="a", value="1")
    # a get the servicer answers with nothing decodes to None
    assert client.get(msgs.SyncRequest(sync_name="s")) is None
    assert stub.reports == [msgs.KeyValuePair(key="a", value="1")]


def test_a_failing_get_raises_remote_error(server):
    srv, _ = server
    client = comm.MasterTransportClient(f"localhost:{srv.port}", retries=1)
    with pytest.raises(comm.RemoteError, match="boom"):
        client.get(msgs.KeyRequest(key="boom"))


@pytest.mark.parametrize("name,item", [
    ("NetworkReadyRequest", "A20"), ("StrategySearchRequest", "A20"),
])
def test_an_unported_handler_answers_with_its_roadmap_item(server, name,
                                                            item):
    srv, _ = server
    client = comm.MasterTransportClient(f"localhost:{srv.port}", retries=1)
    raw = jmsgs.serialize(jmsgs._REGISTRY[name]())
    for method in (b"r", b"g"):
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            client.call(method, raw)


def _jax_master_reply(servicer, method, raw):
    """What the JAX master's transport sends back for ``raw``
    (``dlrover_tpu/common/comm.py``: a report's ``Response``, a get's
    reply or ``Empty``)."""
    msg = jmsgs.deserialize(raw)
    if method == b"r":
        return jmsgs.serialize(jmsgs.Response(
            success=bool(servicer.report(msg))))
    resp = servicer.get(msg)
    return jmsgs.serialize(jmsgs.Empty() if resp is None else resp)


_TUNING = json.dumps({"version": 0, "origin": "revision", "knob":
                      "batch_size", "signal": "oom", "batch_size": 2})
# a JAX-encoded message of each type the planning loop ported, with the
# masters in the same state (a tuning directive, a sparse server set)
ANSWERED = [
    jmsgs.BrainOptimizeRequest(job_name="j", stage="running",
                               stats_json='{"worker_num": 1}'),
    jmsgs.ParallelConfigRequest(node_id=0),
    jmsgs.PsVersionRequest(node_id=0, version_type="global"),
    jmsgs.PsVersionReport(node_id=0, version_type="global"),
    jmsgs.PsVersionReport(node_id=3, version_type="node", version=5),
    jmsgs.TuningPlanNotice(node_id=0, plan_json=_TUNING, signal="oom",
                           reason="oom at remat=full; batch 4→2"),
    jmsgs.TuningPlanRequest(node_id=0),
    jmsgs.BrainPersistMetricsRequest(metrics_json='{"job_name": "j"}'),
    jmsgs.BrainJobMetricsRequest(job_name="j"),
    jmsgs.NetworkCheckResult(node_id=0, elapsed_time=1.5, succeeded=True),
    jmsgs.NetworkCheckStatusRequest(node_id=0),
    # the serving tier's messages (refused before A15 came)
    jmsgs.ServingEvictionNotice(node_id=0, replica="serving-7",
                                in_flight=2, deadline_s=5.0, reason="evict"),
    jmsgs.ServingReshardRequest(node_id=0),
    jmsgs.ServingScaleNotice(node_id=0, role="decode", direction="out",
                             n_before=1, n_after=2, signal="tpot_breach"),
    jmsgs.ServingScaleRequest(node_id=0, role="decode"),
]


@pytest.mark.parametrize("msg", ANSWERED, ids=lambda m: type(m).__name__)
def test_a_jax_encoded_message_is_answered_as_the_jax_master_answers(msg):
    """The cases that were refused before the planning loop came (the
    tuning, parallel-config, PS version and Brain messages) and before
    the serving tier came (its reshard and scale messages): the port's
    master over its transport and the JAX master's servicer, each with a
    node registered, a tuning directive and a sparse server set, answer
    the same bytes, and the state after a report is the same. The Brain
    messages reach a job master unhandled in both (the Brain process
    answers them: ``tests/test_torch_brain.py``)."""
    from dlrover_tpu.master.elastic_ps import ElasticPsService as JPs
    from dlrover_tpu.master.node_manager import JobManager as JManager
    from dlrover_tpu_torch.master.master import JobMaster

    jm, jps = JManager(num_workers=1), JPs()
    theirs = JServicer(job_manager=jm, ps_service=jps)
    master = JobMaster(port=0, num_workers=1)
    master.prepare()
    try:
        jm.register_node(jmsgs.NodeMeta(node_id=0, node_rank=0))
        master.job_manager.register_node(msgs.NodeMeta(node_id=0,
                                                       node_rank=0))
        for m in (jm, master.job_manager):
            m.plan_tuning(_TUNING, reason="oom")
            m.plan_serving_reshard("serving-7", survivors=["serving-8"],
                                   deadline_s=3.0, reason="drain")
            m.plan_serving_scale("decode", 3, reason="tpot")
        for ps in (jps, master.ps_service):
            ps.set_servers(["ps-0", "ps-1"])
            ps.set_weights({"ps-0": 0.5})
        client = comm.MasterTransportClient(master.addr, retries=1)
        raw = jmsgs.serialize(msg)
        for method in (b"r", b"g"):
            assert client.call(method, raw) == _jax_master_reply(
                theirs, method, raw), method
        assert master.ps_service.get_global_version() == \
            jps.get_global_version()
        assert master.ps_service.get_node_version(3) == \
            jps.get_node_version(3)
        assert master.job_manager.get_tuning() == jm.get_tuning()
        assert master.job_manager.get_serving_reshard() == \
            jm.get_serving_reshard()
        assert master.job_manager.get_serving_scale() == \
            jm.get_serving_scale()
    finally:
        master.stop()


def test_a_jax_resource_stats_report_reaches_the_diagnosis_manager():
    """``ResourceStats`` was unported until the agent's monitor came
    (A12's agent half): a JAX-encoded report now lands in the master's
    diagnosis history."""
    from dlrover_tpu_torch.master.master import JobMaster

    master = JobMaster(port=0, num_workers=1)
    master.prepare()
    try:
        client = comm.MasterTransportClient(master.addr, retries=1)
        raw = jmsgs.serialize(jmsgs.ResourceStats(
            node_id=0, cpu_percent=4.0, used_memory_mb=9.0, hbm_used_mb=2.0,
            hbm_peak_mb=3.0))
        client.call(b"r", raw)
        hist = master.diagnosis_manager.resource_history[0][0]
        assert (hist["cpu"], hist["mem_mb"], hist["hbm_mb"],
                hist["hbm_peak_mb"]) == (4.0, 9.0, 2.0, 3.0)
    finally:
        master.stop()


def test_every_jax_request_is_handled_or_named_unported():
    jax_requests = set(JServicer._REPORT_HANDLERS) | set(
        JServicer._GET_HANDLERS)
    port = set(MasterServicer._REPORT_HANDLERS) | set(
        MasterServicer._GET_HANDLERS)
    assert jax_requests - port <= set(UNPORTED)
    assert not port & set(UNPORTED)
    assert set(UNPORTED) <= set(jmsgs._REGISTRY)


def test_the_backoff_is_the_jax_package_schedule():
    for seed in range(3):
        random.seed(seed)
        mine = [comm._backoff_delay(a) for a in range(12)]
        random.seed(seed)
        theirs = [jcomm._backoff_delay(a) for a in range(12)]
        assert mine == theirs


def test_a_refused_call_retries_on_that_schedule(monkeypatch):
    waits = []
    monkeypatch.setattr(comm, "_wait", waits.append)
    client = comm.MasterTransportClient(
        f"localhost:{comm.find_free_port()}", timeout_s=2.0)
    random.seed(11)
    with pytest.raises(OSError):
        client.report(msgs.HeartbeatReport(node_id=1), retries=4)
    random.seed(11)
    assert waits == [jcomm._backoff_delay(a) for a in range(4)]
