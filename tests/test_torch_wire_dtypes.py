"""ZeRO's gradient wires and the multi-slice layout of the port
(``ops/quant.py`` ``wire_encode_rows``/``wire_decode_sum``,
``parallel/sharding.py`` ``CommConfig``, ``exchange_buckets``,
``resolve_update_sharding``; ``parallel/mesh.py`` ``num_slices``,
``axis_crosses_dcn``) against the JAX package, on the CPU.

- The int8 wire codec is bit-exact against the JAX one: payloads,
  scales and the f32 sum of the decoded rows, over hypothesis-drawn
  rows (all-zero blocks among them).
- ``exchange_buckets`` over 4 gloo ranks (``tests/torch_zero_worker.py``)
  matches the JAX ``exchange_buckets`` in a ``shard_map`` over 4 CPU
  devices on the same per-rank streams, on each wire, with and without
  ``tie_extra``: bf16 bit for bit (its rows summed in the JAX order, row
  0 first); f32 (gloo's reduce-scatter sums in its own order) and int8
  (the jitted JAX decode fuses each dequant multiply and row add into an
  FMA; the eager codec is bit-exact, above) within 1e-6 of the largest
  summed value. Each rank counts the bytes it put
  on the wire: ``(dp−1)/dp`` of the buckets, 4 bytes an element on f32,
  2 on bf16, 1 on int8 plus a 4-byte scale a ``BLOCK``.
- ``resolve_update_sharding`` equals the JAX one on a table of meshes and
  wires: the same ``(active, reason)``, and equal ``PackPlan`` fields.
- The ``num_slices`` rank layout is the JAX ``build_mesh`` device order
  (8 CPU devices), ``dp % num_slices`` raises as in JAX, and
  ``axis_crosses_dcn`` and ``CommConfig.wire_for`` hold on a case table
  (the port's layout decides the slice: JAX's CPU devices carry none);
  a slice whose ranks lie on two nodes raises, and ``build_mesh``
  gathers the node ranks only where the agent set them.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_sp_worker  # noqa: E402
from dlrover_tpu.common import jax_compat  # noqa: E402
from dlrover_tpu.models import decoder as jdec  # noqa: E402
from dlrover_tpu.models.config import get_config as jget  # noqa: E402
from dlrover_tpu.ops import quant as jq  # noqa: E402
from dlrover_tpu.parallel import MeshConfig, build_mesh  # noqa: E402
from dlrover_tpu.parallel import sharding as jshd  # noqa: E402
from dlrover_tpu.train import optimizer as jopt  # noqa: E402
from dlrover_tpu.train import train_step as jts  # noqa: E402
from dlrover_tpu_torch.models import decoder as tdec  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.ops import quant as tq  # noqa: E402
from dlrover_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from dlrover_tpu_torch.parallel import sharding as tshd  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_zero_worker.py")
_LLAMA = ("tiny", dict(n_layer=2, d_model=64, n_head=4, n_kv_head=2,
                       d_ff=128, vocab_size=256, max_seq=32,
                       tie_embeddings=False, dtype="float32"))
_GPT2 = ("gpt2-124m", dict(n_layer=2, d_model=64, n_head=4, d_ff=128,
                           vocab_size=256, max_seq=32, dtype="float32"))
_OPT = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=20)
_WIRES = ("float32", "bfloat16", "int8")
DP = 4


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# ---- the codec ------------------------------------------------------------


@settings(max_examples=40, deadline=None)
@given(r=st.integers(1, 6), blocks=st.integers(1, 4),
       seed=st.integers(0, 2**31 - 1), zero=st.integers(0, 3),
       scale=st.floats(1e-6, 1e4))
def test_wire_codec_is_bit_exact_against_jax(r, blocks, seed, zero, scale):
    rng = np.random.default_rng(seed)
    n = blocks * tq.BLOCK
    rows = (rng.standard_normal((r, n)) * scale).astype(np.float32)
    for i in range(r):  # an all-zero block in some rows
        if (i + zero) % 2 == 0:
            b = (i + zero) % blocks
            rows[i, b * tq.BLOCK:(b + 1) * tq.BLOCK] = 0.0
    jqv, jsc = jq.wire_encode_rows(jnp.asarray(rows))
    tqv, tsc = tq.wire_encode_rows(torch.from_numpy(rows))
    assert tqv.dtype == torch.int8 and tuple(tsc.shape) == (r, blocks)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(_bits(tsc.numpy()), _bits(jsc))
    np.testing.assert_array_equal(
        _bits(tq.wire_decode_sum(tqv, tsc).numpy()),
        _bits(jq.wire_decode_sum(jqv, jsc)))


# ---- the exchange ---------------------------------------------------------


def _plan(which, dp=DP, bucket_bytes=1 << 13):
    name, kw = which
    jcfg, cfg = jget(name, **kw), get_config(name, **kw)
    abs_ = jax.eval_shape(lambda: jdec.init(jax.random.key(0), jcfg))
    jplan = jshd.build_pack_plan(abs_, dp, bucket_bytes,
                                 tie_embeddings=jcfg.tie_embeddings)
    params = dict(tdec.Decoder(cfg, device="meta",
                               trainable=True).named_parameters())
    return jplan, tshd.build_pack_plan(cfg, params, dp, bucket_bytes)


def _jax_exchange(streams, extras, jplan, wire):
    """The JAX ``exchange_buckets`` on each of DP CPU devices, device r
    given ``streams[r]`` (and ``extras[r]``): the ``[n_buckets,
    bucket_elems]`` of every device's columns."""
    mesh = build_mesh(MeshConfig(dp=DP), devices=jax.devices()[:DP])
    tie = extras is not None

    def body(g, z):
        return jshd.exchange_buckets(g[0], jplan, wire, axis="dp",
                                     tie_extra=z[0] if tie else None)

    z = jnp.asarray(extras if tie else np.zeros((DP, 1), np.float32))
    fn = jax_compat.shard_map(body, mesh=mesh, in_specs=(P("dp"), P("dp")),
                              out_specs=P(None, "dp"))
    return np.asarray(jax.jit(fn)(jnp.asarray(streams), z))


@pytest.fixture(scope="module")
def exchanges(tmp_path_factory):
    """Every case's port results (4 gloo ranks, one spawn) beside the
    JAX exchange's."""
    rng = np.random.default_rng(11)
    cases, want = {}, {}
    for which, wid in ((_LLAMA, "untied"), (_GPT2, "tied")):
        jplan, plan = _plan(which)
        streams = np.zeros((DP, plan.n_buckets, plan.bucket_elems),
                           np.float32)
        flat = streams.reshape(DP, -1)
        flat[:, :plan.total] = rng.standard_normal(
            (DP, plan.total)).astype(np.float32)
        flat[:, :plan.total] *= rng.uniform(
            0.01, 3.0, size=(DP, 1)).astype(np.float32)
        for tied in ((False, True) if plan.tie_size else (False,)):
            extras = (rng.standard_normal((DP, plan.tie_size))
                      .astype(np.float32) if tied else None)
            for wire in _WIRES:
                cid = f"{wid}-{wire}-{'tie' if tied else 'plain'}"
                cases[cid] = {
                    "plan": plan, "wire": wire,
                    "streams": torch.from_numpy(streams),
                    "tie_extra": (None if extras is None
                                  else torch.from_numpy(extras))}
                want[cid] = _jax_exchange(streams, extras, jplan, wire)
    ranks = torch_sp_worker.spawn("exchange", {"cases": cases}, DP,
                                  tmp_path_factory.mktemp("exchange"),
                                  script=WORKER)
    return cases, want, ranks


_CASE_IDS = [f"{w}-{wire}-{t}" for w, ts in (("untied", ("plain",)),
                                             ("tied", ("plain", "tie")))
             for t in ts for wire in _WIRES]


@pytest.mark.parametrize("cid", _CASE_IDS)
def test_exchange_matches_the_jax_exchange(exchanges, cid):
    cases, want, ranks = exchanges
    plan, wire = cases[cid]["plan"], cases[cid]["wire"]
    full = want[cid]
    for r, out in enumerate(ranks):
        got = out[cid]["shard"].numpy()
        ref = full[:, plan.columns(r)]
        assert got.shape == (plan.n_buckets, plan.bucket_elems // DP)
        if wire == "bfloat16":
            np.testing.assert_array_equal(_bits(got), _bits(ref))
        else:
            # f32: gloo's sum order; int8: the jitted JAX decode contracts
            # each row's dequant multiply and add into one FMA (its eager
            # codec is bit-exact: test_wire_codec_is_bit_exact_against_jax)
            bound = 1e-6 * float(np.abs(ref).max())
            np.testing.assert_allclose(got, ref, rtol=0, atol=bound)
        n = plan.n_buckets + (plan.n_tie_buckets if cases[cid]["tie_extra"]
                              is not None else 0)
        assert out[cid]["bytes"] == tshd.wire_bytes(plan, wire, n)
    # the quantized wires really quantize: not the f32 sum
    if wire != "float32":
        f32 = want[cid.replace(wire, "float32")]
        assert not np.array_equal(_bits(full), _bits(f32))


def test_wire_bytes_are_the_plans_count():
    _, plan = _plan(_LLAMA)
    payload = plan.padded * (DP - 1) // DP
    assert tshd.wire_bytes(plan, "int8") == payload + 4 * (
        payload // tq.BLOCK)
    assert tshd.wire_bytes(plan, "bfloat16") == 2 * payload
    assert tshd.wire_bytes(plan, "float32") == 4 * payload


# ---- the gate -------------------------------------------------------------


_GATE_MESHES = [dict(dp=4), dict(dp=2, fsdp=2), dict(dp=2, tp=2),
                dict(dp=2, fsdp=2, tp=2), dict(dp=2, sp=2), dict(fsdp=4),
                dict(dp=1), dict(dp=2, pp=2, fsdp=2)]
_GATE_COMMS = [dict(), dict(wire_dtype="bfloat16"), dict(wire_dtype="int8"),
               dict(wire_dtype_dcn="int8"), dict(update_sharding="zero1",
                                                 bucket_mb=0.01)]


@pytest.mark.parametrize("ckw", _GATE_COMMS,
                         ids=["f32", "bf16", "int8", "dcn-int8", "zero1"])
@pytest.mark.parametrize("mkw", _GATE_MESHES,
                         ids=lambda kw: "x".join(f"{k}{v}" for k, v in
                                                 kw.items()))
@pytest.mark.parametrize("which", [_LLAMA, _GPT2], ids=["llama", "gpt2"])
def test_resolve_update_sharding_equals_jax(which, mkw, ckw):
    name, kw = which
    jcfg, cfg = jget(name, **kw), get_config(name, **kw)
    n = int(np.prod(list(mkw.values())))
    jm = build_mesh(MeshConfig(**mkw), devices=jax.devices()[:n])
    ckw = dict(dict(update_sharding=True), **ckw)
    want = jts.resolve_update_sharding(
        jcfg, jm, jopt.make_optimizer(**_OPT), jshd.CommConfig(**ckw))
    params = dict(tdec.Decoder(cfg, device="meta",
                               trainable=True).named_parameters())
    got = tshd.resolve_update_sharding(
        cfg, params, n, tshd.CommConfig(**ckw),
        tmesh.Mesh(tmesh.MeshConfig(**mkw).resolved_sizes(n), 0))
    assert got[:2] == want[:2]
    if want[0]:
        for field in ("shapes", "sizes", "offsets", "total",
                      "bucket_elems", "n_buckets", "dp", "tie_size",
                      "n_tie_buckets", "mesh_axes"):
            assert getattr(got[2], field) == getattr(want[2], field), field
    else:
        assert got[2] is None


def test_comm_config_takes_every_wire_and_refuses_others():
    for wire in _WIRES:
        assert tshd.CommConfig(update_sharding=True,
                               wire_dtype=wire).wire_dtype == wire
        assert tshd.CommConfig(wire_dtype_dcn=wire).wire_dtype_dcn == wire
    for kw in (dict(wire_dtype="fp8"), dict(wire_dtype_dcn="int4"),
               dict(wire_dtype=None)):
        with pytest.raises(ValueError):
            tshd.CommConfig(**kw)
        with pytest.raises(ValueError):
            jshd.CommConfig(**kw)


# ---- the multi-slice layout ----------------------------------------------


@pytest.mark.parametrize("kw", [dict(dp=2, fsdp=4, num_slices=2),
                                dict(dp=4, fsdp=-1, num_slices=4),
                                dict(dp=4, tp=2, num_slices=2),
                                dict(dp=8, num_slices=2)])
def test_slice_layout_is_the_jax_device_order(kw):
    m = build_mesh(MeshConfig(**kw))
    sizes = dict(m.shape)
    ids = np.vectorize(lambda d: d.id)(m.devices)
    for idx in np.ndindex(ids.shape):
        assert tmesh.rank_coords(int(ids[idx]), sizes) == dict(
            zip(tmesh.MESH_AXES, idx))
    # slice-major: the JAX emulation's contiguous device blocks, one a
    # slice, are the port's slices
    n = kw["num_slices"]
    dp_ids = np.moveaxis(ids, 0, 0).reshape(n, -1)
    for s, block in enumerate(dp_ids):
        assert {tmesh.slice_of(int(r), ids.size, n) for r in block} == {s}


@pytest.mark.parametrize("kw,n", [(dict(dp=3, num_slices=2), 3),
                                  (dict(dp=2, fsdp=2, num_slices=4), 4)])
def test_dp_not_divisible_by_num_slices_raises_as_jax(kw, n):
    with pytest.raises(ValueError, match="divisible by num_slices"):
        build_mesh(MeshConfig(**kw), devices=jax.devices()[:n])
    sizes = tmesh.MeshConfig(**kw).resolved_sizes(n)
    with pytest.raises(ValueError, match="divisible by num_slices"):
        tmesh.check_slices(sizes, kw["num_slices"])
    with pytest.raises(ValueError, match="divisible by num_slices"):
        tmesh.Mesh(sizes, 0, num_slices=kw["num_slices"])


# (mesh kwargs, world, num_slices, {axis: crosses})
_DCN = [
    (dict(dp=4), 4, 1, {"dp": False}),
    (dict(dp=4), 4, 2, {"dp": True, "fsdp": False}),
    (dict(dp=4), 4, 4, {"dp": True}),
    (dict(dp=2, fsdp=2), 4, 2, {"dp": True, "fsdp": False, "tp": False}),
    (dict(dp=2, tp=2), 4, 2, {"dp": True, "tp": False}),
    (dict(dp=4, fsdp=2), 8, 2, {"dp": True, "fsdp": False}),
    (dict(dp=2, fsdp=2, tp=2), 8, 1, {"dp": False, "fsdp": False}),
    (dict(dp=2, sp=2), 4, 2, {"dp": True, "sp": False}),
]


@pytest.mark.parametrize("kw,world,slices,want", _DCN)
def test_axis_crosses_dcn_and_wire_for(kw, world, slices, want):
    sizes = tmesh.MeshConfig(**kw).resolved_sizes(world)
    comm = tshd.CommConfig(update_sharding=True, wire_dtype="bfloat16",
                           wire_dtype_dcn="int8")
    plain = tshd.CommConfig(update_sharding=True, wire_dtype="bfloat16")
    for rank in range(world):
        mesh = tmesh.Mesh(sizes, rank, num_slices=slices)
        for axis, crosses in want.items():
            assert tmesh.axis_crosses_dcn(mesh, axis) is crosses, axis
            assert comm.wire_for(mesh, axis) == ("int8" if crosses
                                                 else "bfloat16")
            assert plain.wire_for(mesh, axis) == "bfloat16"
    assert comm.wire_for(None) == "bfloat16"


@pytest.mark.parametrize("nodes,slices,bad", [
    ([0, 0, 1, 1], 2, None), ([0, 0, 0, 0], 2, None), ([0, 1, 2, 3], 4, None),
    ([0, 0, 0, 1], 2, 1), ([0, 1, 0, 1], 2, 0), ([0, 0, 1, 1], 1, 0)])
def test_a_slice_on_two_nodes_raises(nodes, slices, bad):
    if bad is None:
        tmesh.check_slice_nodes(nodes, slices)
        return
    with pytest.raises(ValueError, match=f"slice {bad} of {slices}"):
        tmesh.check_slice_nodes(nodes, slices)


def test_build_mesh_gathers_the_node_ranks(monkeypatch):
    """Under the agent (its node rank in the environment) build_mesh
    gathers every rank's node and refuses a slice across two; without it
    no gather runs."""
    monkeypatch.setattr(tmesh.dist, "is_available", lambda: True)
    monkeypatch.setattr(tmesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(tmesh.dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(tmesh.dist, "get_rank", lambda group=None: 0)
    gathered = []

    def gather(out, obj):
        gathered.append(obj)
        out[:] = [0, 1, 0, 1]  # the launcher placed ranks round-robin

    monkeypatch.setattr(tmesh.dist, "all_gather_object", gather)
    monkeypatch.delenv("DLROVER_TPU_NODE_RANK", raising=False)
    mesh = tmesh.build_mesh(tmesh.MeshConfig(dp=4, num_slices=2))
    assert mesh.num_slices == 2 and gathered == []
    monkeypatch.setenv("DLROVER_TPU_NODE_RANK", "0")
    with pytest.raises(ValueError, match="spans nodes"):
        tmesh.build_mesh(tmesh.MeshConfig(dp=4, num_slices=2))
    assert gathered == [0]
