"""The port's Flash Checkpoint against the JAX package's, on the CPU.

- the pack header: byte for byte the JAX header for the same leaves,
  and for a train state the same leaf paths, dtypes and global shapes
  (the optax state's paths for each optimizer setting the port has);
- packs cross both ways bit for bit: a pack written by the JAX
  ``write_pack`` restores in the port, and the port's restores through the
  JAX ``restore_tree``, with bf16 moments, the scalar step and counts and
  the layer-stacked leaves the port writes as L shards;
- the ``step_N/`` + ``latest.txt`` layout and the deletion strategies;
- the engine: memory tier before storage, a tree mismatch re-raised, a
  memory save skipped while a persist holds the lock (so the committed
  pack is the staged one, never a later step's), a staged pack unchanged
  by an in-place step after it, and a clear error when /dev/shm is short.

Each test stages under a run id of its own and removes its segment.
"""

import os
import threading
import uuid

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from dlrover_tpu.checkpoint import core as jcore  # noqa: E402
from dlrover_tpu.checkpoint import storage as jstorage  # noqa: E402
from dlrover_tpu.models.config import get_config as jget  # noqa: E402
from dlrover_tpu.parallel.mesh import single_device_mesh  # noqa: E402
from dlrover_tpu.train import optimizer as jopt  # noqa: E402
from dlrover_tpu.train import train_step as jts  # noqa: E402
from dlrover_tpu_torch.checkpoint import Checkpointer, core  # noqa: E402
from dlrover_tpu_torch.checkpoint import storage  # noqa: E402
from dlrover_tpu_torch.checkpoint.engine import (  # noqa: E402
    CheckpointEngine,
)
from dlrover_tpu_torch.models import convert  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.train import optimizer as topt  # noqa: E402
from dlrover_tpu_torch.train import train_step as tts  # noqa: E402

_CFG = dict(n_layer=2, d_model=64, n_head=2, n_kv_head=1, d_ff=128,
            vocab_size=256, max_seq=32, tie_embeddings=False,
            dtype="float32")
# the optimizer settings whose optax state layouts differ: the clip link,
# a schedule's count, the fused walk, bf16 first moments
_OPTS = {
    "chain": dict(learning_rate=1e-3, warmup_steps=2, decay_steps=20,
                  grad_clip=1.0),
    "no_clip_constant": dict(learning_rate=1e-3, grad_clip=0.0,
                             schedule="constant"),
    "fused": dict(learning_rate=1e-3, warmup_steps=2, decay_steps=20,
                  grad_clip=1.0, fused=True),
    "bf16": dict(learning_rate=1e-3, warmup_steps=2, decay_steps=20,
                 grad_clip=1.0, state_dtype="bfloat16"),
}


@pytest.fixture(autouse=True)
def _run_id(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_RUN_ID", "ckpt" + uuid.uuid4().hex[:12])
    yield
    CheckpointEngine.unlink_segment()


def _jax_state(opt_kw, seed=0):
    """A JAX train state with every leaf filled from ``seed`` (so nothing
    restores by being zero), its step and counts 7; and the port state of
    the same structure."""
    jcfg = jget("tiny", **_CFG)
    jtx = jopt.make_optimizer(**opt_kw)
    st = jts.init_train_state(jax.random.key(0), jcfg,
                              single_device_mesh(), jtx)
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if x.dtype.kind == "i":
            return np.full(x.shape, 7, x.dtype)
        return rng.standard_normal(x.shape).astype(x.dtype)

    st = jax.tree.map(fill, st)
    cfg = get_config("tiny", **_CFG)
    ttx = topt.make_optimizer(**opt_kw)
    return st, cfg, ttx, tts.init_train_state(1, cfg, ttx, device="cpu")


def _flat(tree):
    """{path: numpy array} of a JAX tree, bf16 leaves as uint16 words."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(leaf)
        out[jcore._path_str(path)] = (a.view(np.uint16)
                                      if a.dtype.name == "bfloat16" else a)
    return out


def _assert_same_arrays(got, want):
    assert list(got) == list(want)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


def _port_pack(step, leaves, extra=None):
    entries, payload = core.plan_pack(leaves)
    header = core.header_bytes(step, entries, extra)
    buf = torch.zeros(core.pack_size(header, payload), dtype=torch.uint8)
    core.write_pack(buf, leaves, entries, header)
    return buf


def _without_process_fields(doc):
    return {k: v for k, v in doc.items()
            if k not in ("process_index", "process_count")}


def test_header_equals_jax_header_for_the_same_leaves():
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "b": {"c": np.arange(7, dtype=np.int32),
                  "s": np.array(3, np.int32)}}
    jentries, jsize = jcore.plan_pack(tree)
    jheader = jcore.header_bytes(4, jentries, {"dir": "/ckpt"})
    leaves = [core.Leaf(p, core.dtype_name(torch.from_numpy(a).dtype),
                        list(a.shape),
                        [core.Shard([[0, d] for d in a.shape],
                                    torch.from_numpy(a))])
              for p, a in _flat(tree).items()]
    entries, size = core.plan_pack(leaves)
    header = core.header_bytes(4, entries, {"dir": "/ckpt"})
    assert size == jsize
    assert core.read_header(_port_pack(4, leaves, {"dir": "/ckpt"})) == \
        core.read_header(memoryview(_jax_pack(4, tree)))
    import json

    assert _without_process_fields(json.loads(header)) == \
        _without_process_fields(json.loads(jheader))


def _jax_pack(step, tree):
    entries, payload = jcore.plan_pack(tree)
    header = jcore.header_bytes(step, entries, {"dir": "/ckpt"})
    buf = bytearray(jcore.pack_size(header, payload))
    jcore.write_pack(memoryview(buf), step, tree, entries, header=header)
    return buf


@pytest.mark.parametrize("opt", sorted(_OPTS))
def test_train_state_leaves_follow_the_jax_train_state(opt):
    """Same paths in the same order, dtypes and global shapes; each
    stacked leaf's L shards tile its global shape."""
    st, cfg, ttx, state = _jax_state(_OPTS[opt])
    jentries, _ = jcore.plan_pack(st)
    leaves = convert.train_state_leaves(state, cfg, ttx)
    assert [(e.path, e.dtype, e.global_shape) for e in jentries] == \
        [(x.path, x.dtype, x.global_shape) for x in leaves]
    for leaf in leaves:
        covered = sum(int(np.prod([b - a for a, b in s.index]))
                      for s in leaf.shards)
        assert covered == int(np.prod(leaf.global_shape)), leaf.path
        if "/layers/attn/" in leaf.path or "/layers/mlp/" in leaf.path:
            assert len(leaf.shards) == cfg.n_layer
            assert all(s.transposed for s in leaf.shards)


@pytest.mark.parametrize("opt", ["chain", "bf16"])
def test_a_jax_pack_restores_in_the_port_bit_for_bit(opt):
    st, cfg, ttx, state = _jax_state(_OPTS[opt], seed=1)
    idx = core.PackIndex()
    idx.add_pack(_jax_pack(7, st))
    leaves = convert.train_state_leaves(state, cfg, ttx)
    assert core.restore_leaves(leaves, idx) == []
    convert.load_scalars(state, leaves, ttx)
    assert idx.step == 7 and state["step"] == 7
    assert state["opt_state"]["step"] == 7
    _assert_same_arrays(convert.train_state_arrays(state, cfg, ttx),
                        _flat(st))


@pytest.mark.parametrize("opt", ["chain", "bf16"])
def test_a_port_pack_restores_in_jax_bit_for_bit(opt):
    st, cfg, ttx, state = _jax_state(_OPTS[opt], seed=2)
    convert.load_train_state_arrays(state, _flat(st), cfg, ttx)
    buf = _port_pack(7, convert.train_state_leaves(state, cfg, ttx),
                     {"dir": "/ckpt"})
    idx = jcore.PackIndex()
    idx.add_pack(memoryview(buf.numpy()))
    template = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                            st)
    restored = jcore.restore_tree(template, idx)
    idx.close()
    _assert_same_arrays(_flat(restored), _flat(st))


def test_the_step_directory_and_tracker_layout(tmp_path):
    """The port's persist writes what the JAX storage reads, and the
    reverse."""
    _, cfg, ttx, state = _jax_state(_OPTS["chain"])
    d = str(tmp_path / "ckpt")
    eng = CheckpointEngine(d)
    assert eng.save_to_storage(3, convert.train_state_leaves(state, cfg, ttx))
    assert eng.wait_for_persist(60)
    eng.close()
    assert sorted(os.listdir(d)) == ["latest.txt", "step_3"]
    assert sorted(os.listdir(os.path.join(d, "step_3"))) == [
        "done", "host_0.pack"]
    assert os.listdir(os.path.join(d, "step_3", "done")) == ["host_0.done"]
    assert Checkpointer(d).latest_committed_step() == 3
    js = jstorage.PosixStorage()
    assert jstorage.read_tracker(d, js) == 3
    assert jstorage.committed_steps(d, js) == [3]
    jstorage.write_tracker(d, 9, js)
    assert storage.read_tracker(d, storage.PosixStorage()) == 9


@pytest.mark.parametrize("strategy,keep", [
    ("KeepLatestStepStrategy", dict(max_to_keep=2)),
    ("KeepStepIntervalStrategy", dict(interval=2)),
])
def test_deletion_strategies_keep_what_jax_keeps(tmp_path, strategy, keep):
    kept = []
    for mod, st in ((storage, storage.PosixStorage()),
                    (jstorage, jstorage.PosixStorage())):
        d = tmp_path / mod.__name__.split(".")[0]
        for step in (1, 2, 3, 4, 5):
            (d / f"step_{step}").mkdir(parents=True)
        mod.write_tracker(str(d), 5, st)
        getattr(mod, strategy)(**keep).clean_up(str(d), st)
        kept.append(sorted(mod.committed_steps(str(d), st)))
    assert kept[0] == kept[1]
    assert 5 in kept[0] and len(kept[0]) < 5


def _leaves_and_values(seed=3):
    _, cfg, ttx, state = _jax_state(_OPTS["chain"])
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in state["params"].parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    return cfg, ttx, state


def _snapshot(state, cfg, ttx):
    return convert.train_state_arrays(state, cfg, ttx)


def test_engine_memory_tier_first_then_storage(tmp_path):
    cfg, ttx, state = _leaves_and_values()
    d = str(tmp_path / "ckpt")
    eng = CheckpointEngine(d)
    state["step"] = 2
    eng.save_to_storage(2, convert.train_state_leaves(state, cfg, ttx))
    eng.wait_for_persist(60)
    at2 = _snapshot(state, cfg, ttx)
    with torch.no_grad():
        for p in state["params"].parameters():
            p.add_(1.0)
    state["step"] = 3
    eng.save_to_memory(3, convert.train_state_leaves(state, cfg, ttx))
    at3 = _snapshot(state, cfg, ttx)
    eng.close()

    def restore(step=None):
        _, _, _, fresh = _jax_state(_OPTS["chain"])
        leaves = convert.train_state_leaves(fresh, cfg, ttx)
        new = CheckpointEngine(d)
        got = new.load(leaves, step=step)
        convert.load_scalars(fresh, leaves, ttx)
        return got, new.timings[-1]["tier"], _snapshot(fresh, cfg, ttx)

    got, tier, arrays = restore()
    assert (got, tier) == (3, "memory")
    _assert_same_arrays(arrays, at3)
    got, tier, arrays = restore(step=2)  # memory holds 3: storage
    assert (got, tier) == (2, "storage")
    _assert_same_arrays(arrays, at2)
    assert CheckpointEngine.unlink_segment()
    got, tier, arrays = restore()
    assert (got, tier) == (2, "storage")
    _assert_same_arrays(arrays, at2)


def test_engine_reraises_a_tree_mismatch_and_finds_nothing_as_none(tmp_path):
    cfg, ttx, state = _leaves_and_values()
    leaves = convert.train_state_leaves(state, cfg, ttx)
    d = str(tmp_path / "ckpt")
    assert CheckpointEngine(d).load(leaves) is None
    eng = CheckpointEngine(d)
    eng.save_to_storage(1, leaves[1:])  # the pack lacks one leaf
    eng.wait_for_persist(60)
    eng.close()
    with pytest.raises(core.RestoreMismatchError, match=leaves[0].path):
        CheckpointEngine(d).load(leaves)
    # partial keeps the leaf's own value (not a params leaf here)
    assert not leaves[0].path.startswith("params")
    assert CheckpointEngine(d).load(leaves, partial=True) == 1


class _GatedStorage(storage.PosixStorage):
    """Storage whose pack write waits for ``gate``."""

    def __init__(self):
        self.gate = threading.Event()
        self.entered = threading.Event()

    def write_bytes(self, data, path):
        if path.endswith(".pack"):
            self.entered.set()
            assert self.gate.wait(60)
        super().write_bytes(data, path)


def test_memory_save_skips_while_a_persist_holds_the_lock(tmp_path):
    """The committed pack is the step staged for it: a memory save during
    the persist is skipped, not written under the persist."""
    cfg, ttx, state = _leaves_and_values()
    d = str(tmp_path / "ckpt")
    st = _GatedStorage()
    eng = CheckpointEngine(d, storage=st)
    state["step"] = 1
    assert eng.save_to_storage(1, convert.train_state_leaves(state, cfg, ttx))
    at1 = _snapshot(state, cfg, ttx)
    assert st.entered.wait(60)
    with torch.no_grad():
        for p in state["params"].parameters():
            p.mul_(-1.0)
    state["step"] = 2
    assert not eng.save_to_memory(2, convert.train_state_leaves(state, cfg,
                                                                ttx))
    assert eng.timings[-1] == {"kind": "skipped", "step": 2}
    st.gate.set()
    assert eng.wait_for_persist(60)
    eng.close()
    assert CheckpointEngine.unlink_segment()
    _, _, _, fresh = _jax_state(_OPTS["chain"])
    leaves = convert.train_state_leaves(fresh, cfg, ttx)
    assert CheckpointEngine(d).load(leaves) == 1
    convert.load_scalars(fresh, leaves, ttx)
    _assert_same_arrays(_snapshot(fresh, cfg, ttx), at1)


def test_a_step_after_staging_leaves_the_pack_unchanged(tmp_path):
    cfg, ttx, state = _leaves_and_values()
    step = tts.TrainStepBuilder(cfg, ttx, device="cpu").build()
    rng = np.random.default_rng(4)
    tok = torch.from_numpy(rng.integers(0, 256, size=(2, 17)))
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    eng = CheckpointEngine(str(tmp_path / "ckpt"))
    assert eng.save_to_memory(0, convert.train_state_leaves(state, cfg, ttx))
    staged = _snapshot(state, cfg, ttx)
    step(state, batch)  # in place, right after the save returned
    moved = _snapshot(state, cfg, ttx)
    mu = "opt_state/1/0/mu/lm_head/w"  # lr is 0 at step 1: the moments move
    assert not np.array_equal(moved[mu], staged[mu])
    _, _, _, fresh = _jax_state(_OPTS["chain"])
    leaves = convert.train_state_leaves(fresh, cfg, ttx)
    assert eng.load(leaves) == 0
    convert.load_scalars(fresh, leaves, ttx)
    _assert_same_arrays(_snapshot(fresh, cfg, ttx), staged)
    eng.close()


def test_a_short_dev_shm_raises_naming_both_sizes(tmp_path, monkeypatch):
    cfg, ttx, state = _leaves_and_values()

    class Tiny:
        f_bavail, f_frsize = 1, 4096

    monkeypatch.setattr(os, "statvfs", lambda path: Tiny)
    eng = CheckpointEngine(str(tmp_path / "ckpt"))
    with pytest.raises(RuntimeError, match=r"has 4096 bytes free.*needs \d+"):
        eng.save_to_memory(0, convert.train_state_leaves(state, cfg, ttx))


def test_a_torn_segment_is_not_restored(tmp_path):
    """A staged pack whose length field reads 0 (a crash mid-write) is
    never read: the memory tier falls through to storage."""
    cfg, ttx, state = _leaves_and_values()
    d = str(tmp_path / "ckpt")
    eng = CheckpointEngine(d)
    eng.save_to_memory(5, convert.train_state_leaves(state, cfg, ttx))
    eng._buf[:core.HEADER_LEN_BYTES] = 0
    eng.close()
    assert CheckpointEngine(d).load(
        convert.train_state_leaves(state, cfg, ttx)) is None
