"""The port's mesh (``dlrover_tpu_torch/parallel/mesh.py``) against the
JAX package's, on the CPU.

- ``MeshConfig.resolved_sizes`` equals JAX's over a table of
  configurations and device counts, errors included;
- the rank → coordinate layout is JAX's: the device at each position of
  the JAX mesh's device array (8 CPU devices, ``tests/conftest.py``) is
  the port's rank with that coordinate, and each axis group lists the
  same ranks in the same order;
- a rank's block of a global batch (``torch_sp_worker.local_batch``: its
  dp rows, and its sp sequence block from ``data_utils.sequence_block``) is the shard JAX's ``batch_sharding``
  puts on that device;
- the layouts the port does not run raise, naming their ROADMAP item
  (pp, ep: A16), and so does ``Trainer`` given such a mesh; sp with fsdp
  or tp is a port layout (its streams: ``tests/test_torch_mesh4d.py``;
  fsdp and tp themselves: ``tests/test_torch_fsdp_tp.py``);
- ``Trainer`` given ``MeshConfig(dp=2, sp=2)`` in 4 gloo processes
  (``tests/torch_sp_worker.py``) trains on it: its 2 losses equal the
  one-process ``TrainStepBuilder``'s on the global batches, and its
  evaluation at the end (each rank its block, the metrics summed over
  the world) the one-process ``loss_fn`` on the trained weights, within
  1e-5 relative (f32; ``test_torch_sp_train.py``'s tolerance).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import torch_sp_worker  # noqa: E402
from dlrover_tpu.parallel import mesh as jmesh  # noqa: E402
from dlrover_tpu.train.train_step import batch_sharding  # noqa: E402
from dlrover_tpu_torch.models import decoder  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from dlrover_tpu_torch.train import optimizer as topt  # noqa: E402
from dlrover_tpu_torch.train import train_step as tts  # noqa: E402
from dlrover_tpu_torch.train import trainer as ttrainer  # noqa: E402

_SIZES = [
    (dict(), 8), (dict(dp=2, sp=4), 8), (dict(dp=-1, sp=2), 8),
    (dict(sp=-1, dp=2), 8), (dict(dp=2, sp=2, tp=2), 8),
    (dict(fsdp=-1, tp=2), 4), (dict(dp=3), 8), (dict(dp=-1, sp=-1), 8),
    (dict(dp=2, sp=2), 8), (dict(pp=2, ep=2, dp=-1), 8), (dict(dp=1), 1),
]


@pytest.mark.parametrize("kw,n", _SIZES)
def test_resolved_sizes_equal_jax(kw, n):
    try:
        want = jmesh.MeshConfig(**kw).resolved_sizes(n)
    except ValueError as e:
        with pytest.raises(ValueError):
            tmesh.MeshConfig(**kw).resolved_sizes(n)
        assert str(e)
        return
    assert tmesh.MeshConfig(**kw).resolved_sizes(n) == want


@pytest.mark.parametrize("kw", [dict(dp=2, sp=4), dict(dp=4, sp=2),
                                dict(dp=2, sp=2, tp=2),
                                dict(pp=2, fsdp=2, sp=2)])
def test_rank_layout_is_the_jax_device_order(kw):
    m = jmesh.build_mesh(jmesh.MeshConfig(**kw))
    sizes = dict(m.shape)
    assert tuple(m.axis_names) == tmesh.MESH_AXES
    ids = np.vectorize(lambda d: d.id)(m.devices)
    for idx in np.ndindex(ids.shape):
        coords = dict(zip(tmesh.MESH_AXES, idx))
        assert tmesh.rank_coords(int(ids[idx]), sizes) == coords
        assert tmesh.coords_rank(coords, sizes) == int(ids[idx])
    for axis in tmesh.MESH_AXES:
        pencils = np.moveaxis(ids, tmesh.MESH_AXES.index(axis), -1)
        want = sorted(p.tolist() for p in pencils.reshape(-1, sizes[axis]))
        assert sorted(tmesh.axis_groups(sizes, axis)) == want
        for rank in range(ids.size):
            mine = tmesh.Mesh(sizes, rank).ranks(axis)
            assert mine in want and rank in mine


@pytest.mark.parametrize("kw", [dict(dp=2, sp=4), dict(dp=8),
                                dict(dp=4, sp=2)])
def test_local_batch_is_the_jax_shard(kw):
    m = jmesh.build_mesh(jmesh.MeshConfig(**kw))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 100, size=(8, 32)).astype(np.int32)
    prefix = rng.integers(0, 32, size=(8,)).astype(np.int32)
    arr = jax.device_put(tokens, batch_sharding(m))
    for shard in arr.addressable_shards:
        mine = torch_sp_worker.local_batch(
            {"tokens": tokens, "prefix_len": prefix},
            tmesh.Mesh(dict(m.shape), shard.device.id))
        np.testing.assert_array_equal(mine["tokens"].numpy(),
                                      np.asarray(shard.data))
        rows = shard.index[0]
        np.testing.assert_array_equal(mine["prefix_len"].numpy(),
                                      prefix[rows])


@pytest.mark.parametrize("kw,item", [
    (dict(fsdp=2, sp=2), None), (dict(tp=2, sp=2), None), (dict(pp=2), "A16"),
    (dict(ep=2), "A16")])
def test_unported_axes_raise_naming_their_item(tmp_path, kw, item):
    """pp and ep raise naming A16. sp with fsdp or tp (item None) passes
    the check; in one process its four ranks do not fit the world, which
    ``build_mesh`` and ``Trainer`` refuse as JAX's ``resolved_sizes``
    does; every rank's groups are the JAX mesh's
    (``test_rank_layout_is_the_jax_device_order``)."""
    world = int(np.prod(list(kw.values())))
    cfg = get_config("tiny", **_CFG)
    if item is None:
        tmesh.check_ported(tmesh.MeshConfig(**kw).resolved_sizes(world))
        for call in (lambda: tmesh.build_mesh(tmesh.MeshConfig(**kw)),
                     lambda: ttrainer.Trainer(
                         cfg, ttrainer.TrainerArgs(output_dir=str(tmp_path)),
                         [], topt.make_optimizer(**_OPT), device="cpu",
                         mesh=tmesh.MeshConfig(**kw))):
            with pytest.raises(ValueError, match="device count 1"):
                call()
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tmesh.build_mesh(tmesh.MeshConfig(**kw))
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tmesh.check_ported(tmesh.MeshConfig(**kw).resolved_sizes(world))
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        ttrainer.Trainer(cfg, ttrainer.TrainerArgs(output_dir=str(tmp_path)),
                         [], topt.make_optimizer(**_OPT), device="cpu",
                         mesh=tmesh.MeshConfig(**kw))


def test_one_process_mesh_is_all_ones():
    m = tmesh.build_mesh()
    assert m.shape == {a: 1 for a in tmesh.MESH_AXES} and m.size == 1
    assert m.group("sp") is None and m.ranks("sp") == [0]


_CFG = dict(n_layer=2, d_model=64, n_head=4, n_kv_head=2, d_ff=128,
            vocab_size=256, max_seq=64, dtype="float32")
_OPT = dict(learning_rate=1e-3, warmup_steps=1, decay_steps=10)


def test_trainer_trains_on_a_dp_by_sp_mesh(tmp_path):
    cfg = get_config("tiny", **_CFG)
    model = decoder.init(cfg, seed=2, device="cpu", trainable=True)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(3):
        tok = rng.integers(0, 256, size=(4, 65)).astype(np.int64)
        batches.append({"tokens": torch.from_numpy(tok[:, :-1]),
                        "targets": torch.from_numpy(tok[:, 1:])})
    batches, held_out = batches[:2], batches[2]
    ranks = torch_sp_worker.spawn(
        "trainer", {"overrides": _CFG, "opt": _OPT, "state": state,
                    "batches": batches, "eval": held_out,
                    "mesh": {"dp": 2, "sp": 2}, "attn_impl": "ring",
                    "output_dir": str(tmp_path)},
        4, tmp_path)
    tx = topt.make_optimizer(**_OPT)
    st = {"params": model, "opt_state": tx.init(dict(
        model.named_parameters())), "step": 0}
    step = tts.TrainStepBuilder(cfg, tx, device="cpu").build()
    want = [float(step(st, b)[1]["loss"]) for b in batches]
    with torch.no_grad():
        want_eval = float(decoder.loss_fn(model, held_out, cfg)[0])
    for r in ranks:
        assert r["mesh"]["dp"] == 2 and r["mesh"]["sp"] == 2
        np.testing.assert_allclose(r["losses"], want, rtol=1e-5)
        np.testing.assert_allclose(r["evals"], [want_eval], rtol=1e-5)
