"""The port's serving path against the JAX engine.

The JAX side is ``ServingEngine`` + ``Scheduler`` drained in this
thread — the loop the JAX ``GenerationServer`` runs on its background
thread; the port side is the port's ``GenerationServer(device="cpu")``
with its own loop thread. Same weights (``models/convert.py``), same
prompts, tiny config in f32: greedy streams must be token-for-token
equal. The allocators must give the same block tables on the same
admit/grow/evict trace. Sampled streams are the port's own (the draw is
Gumbel-max keyed on seed and position, not threefry) and must not depend
on what else is being served.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from dlrover_tpu.models import decoder as jdec  # noqa: E402
from dlrover_tpu.models.config import get_config as jget  # noqa: E402
from dlrover_tpu.serving import kv_cache as jkv  # noqa: E402
from dlrover_tpu.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from dlrover_tpu.serving.scheduler import Scheduler as JaxScheduler  # noqa: E402
from dlrover_tpu_torch.models import convert  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.serving import kv_cache as tkv  # noqa: E402
from dlrover_tpu_torch.serving.engine import ServingEngine  # noqa: E402
from dlrover_tpu_torch.serving.scheduler import (  # noqa: E402
    AdmissionError, SamplingParams, Scheduler,
)
from dlrover_tpu_torch.serving.server import GenerationServer  # noqa: E402

_KW = dict(n_layer=2, d_model=32, d_ff=64, n_head=4, n_kv_head=2,
           vocab_size=64, max_seq=64, dtype="float32")
_ENGINE = dict(n_slots=3, max_len=32, page_size=4, prefill_chunk=4)
_PROMPT_LENS = (3, 7, 5, 11, 2)
_MAX_NEW = (6, 4, 8, 5, 7)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jget("tiny", **_KW), get_config("tiny", **_KW)
    params = jdec.init(jax.random.key(0), jcfg)
    model = convert.load_jax_params(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, 64, size=n)))
               for n in _PROMPT_LENS]
    return jcfg, cfg, params, model, prompts


def _serve_port(model, cfg, prompts, mode, sampling=None, max_new=_MAX_NEW):
    server = GenerationServer(model, cfg, mode=mode, device="cpu", **_ENGINE)
    server.start()
    try:
        reqs = [server.submit(p, m, sampling=s) for p, m, s in
                zip(prompts, max_new, sampling or [None] * len(prompts))]
        outs = [r.future.result(timeout=120) for r in reqs]
    finally:
        server.stop()
    assert server.error is None
    return server, outs


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_greedy_streams_equal_jax(setup, mode):
    jcfg, cfg, params, model, prompts = setup
    sched = JaxScheduler(replica="jax")
    eng = JaxEngine(params, jcfg, sched, mode=mode, **_ENGINE)
    reqs = [sched.submit(p, m) for p, m in zip(prompts, _MAX_NEW)]
    eng.drain(timeout=600)
    ref = [r.future.result(timeout=5) for r in reqs]
    server, outs = _serve_port(model, cfg, prompts, mode)
    assert outs == ref
    es = server.engine.stats()
    assert es["tokens_generated"] == sum(_MAX_NEW)
    assert es["active_slots"] == 0
    assert server.engine.alloc.free_pages == server.engine.geom.n_pages - 1
    lat = server.scheduler.latency_summary()
    assert lat["n"] == len(prompts) and lat["ttft_p50_ms"] > 0


def test_sampled_stream_independent_of_other_requests(setup):
    _, cfg, _, model, prompts = setup
    sp = SamplingParams(temperature=0.9, top_p=0.9, seed=42)
    _, alone = _serve_port(model, cfg, prompts[3:4], "int8", [sp],
                           max_new=(9,))
    mixed_sampling = [SamplingParams(temperature=1.0, seed=i)
                      for i in range(len(prompts))]
    mixed_sampling[3] = sp
    max_new = list(_MAX_NEW)
    max_new[3] = 9
    _, mixed = _serve_port(model, cfg, prompts, "int8", mixed_sampling,
                           max_new=max_new)
    assert mixed[3] == alone[0]
    assert all(0 <= t < cfg.vocab_size for t in alone[0])


def test_allocator_trace_matches_jax():
    cfg = get_config("tiny", **_KW)
    geom = tkv.make_geometry(cfg, n_slots=4, max_len=24, page_size=4,
                             mode="int8")
    assert tuple(geom) == tuple(jkv.make_geometry(
        jget("tiny", **_KW), n_slots=4, max_len=24, page_size=4,
        mode="int8"))
    assert tkv.resident_bytes(geom) == jkv.resident_bytes(
        jkv.PageGeometry(*geom))
    mine, ref = tkv.PageAllocator(geom, 4), jkv.PageAllocator(
        jkv.PageGeometry(*geom), 4)
    rng = np.random.default_rng(3)
    for _ in range(200):
        slot = int(rng.integers(4))
        op = rng.random()
        n = int(rng.integers(0, geom.max_len + 6))
        if op < 0.35:
            if mine.slot_pages(slot) == 0:
                assert mine.can_admit(n) == ref.can_admit(n)
                assert mine.admit(slot, n) == ref.admit(slot, n)
        elif op < 0.7:
            assert mine.ensure(slot, n) == ref.ensure(slot, n)
        else:
            assert mine.evict(slot) == ref.evict(slot)
        np.testing.assert_array_equal(mine.block_tables(), ref.block_tables())
        assert mine.free_pages == ref.free_pages
        assert mine.consume_dirty() == ref.consume_dirty()


def test_no_hidden_cpu_and_unported_options_raise(setup):
    _, cfg, _, model, prompts = setup
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ServingEngine(model, cfg, Scheduler())
        with pytest.raises(RuntimeError, match="cuda"):
            GenerationServer(model, cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            ServingEngine(model, cfg, Scheduler(), spec_k=2,
                          prefix_sharing=True)
    # the roles are ported (tests/test_torch_fleet.py holds the fleet
    # against the JAX package): each serves here, a prefill replica
    # handing its prompts to a decode replica; the gather engine is not
    from dlrover_tpu_torch.serving.replica import (
        ReplicaRouter, ServingReplica,
    )

    for role in ("prefill", "decode"):
        assert ServingEngine(model, cfg, Scheduler(), device="cpu",
                             role=role, **_ENGINE).role == role
    with pytest.raises(ValueError, match="role"):
        ServingEngine(model, cfg, Scheduler(), device="cpu", role="both")
    reps = [ServingReplica(f"r-{role}", model, cfg, role=role, device="cpu",
                           **_ENGINE).start()
            for role in ("prefill", "decode")]
    router = ReplicaRouter(reps)
    try:
        router.submit(prompts[0], 3)
        assert len(router.wait_all(timeout=60)[0]) == len(prompts[0]) + 3
        assert reps[1].server.engine.stats()["handoffs_in"] == 1
    finally:
        router.close()
        for r in reps:
            r.stop()
    with pytest.raises(NotImplementedError, match="gather engine.*ROADMAP "
                       "A15"):
        ServingEngine(model, cfg, Scheduler(), device="cpu", paged=False)


def test_bad_requests_fail_their_own_futures(setup):
    _, cfg, _, model, prompts = setup
    server = GenerationServer(model, cfg, device="cpu", **_ENGINE)
    with pytest.raises(ValueError, match="capacity"):
        server.submit(list(range(30)), 8)
    server.start()
    try:
        bad = server.submit(prompts[0], 3,
                            sampling=SamplingParams(temperature=-1.0))
        good = server.generate(prompts[1], 3, timeout=60)
        with pytest.raises(AdmissionError, match="temperature"):
            bad.future.result(timeout=60)
    finally:
        server.stop()
    assert len(good) == len(prompts[1]) + 3
    assert server.scheduler.poisoned == 1


def test_tracer_records_the_request_span_chain(setup):
    """With the tracer on, one request leaves its admit → prefill chunk
    → decode chain, tagged with its rid, plus the queue-wait span and
    the occupancy counter the loop publishes."""
    from dlrover_tpu_torch.observability import tracing

    _, cfg, _, model, prompts = setup
    tr = tracing.configure_tracer("test-serving", force=True)
    try:
        server, _ = _serve_port(model, cfg, prompts[3:4], "bf16",
                                max_new=(3,))
        events = tr.events()
    finally:
        tracing.reset_tracer()
    rid = server.scheduler.publish().replica + "/r0"
    names = {e["name"] for e in events if e["args"].get("rid") == rid}
    assert {"serving.admit", "serving.queue_wait", "serving.prefill_chunk",
            "serving.decode"} <= names
    chunks = [e for e in events if e["name"] == "serving.prefill_chunk"]
    assert len(chunks) == -(-len(prompts[3]) // _ENGINE["prefill_chunk"])
    assert any(e["name"].startswith("serving.occupancy.") for e in events)
    assert tracing.get_tracer().enabled is False


def test_serving_record_reads_back_in_the_jax_package(setup):
    from dlrover_tpu.observability import telemetry as jtel

    _, cfg, _, model, prompts = setup
    server, _ = _serve_port(model, cfg, prompts[:2], "int8",
                            max_new=(2, 2))
    rec = server.scheduler.publish(server.engine.stats())
    back = jtel.from_json(rec.to_json())
    assert back.completed == 2 and back.replica == rec.replica
