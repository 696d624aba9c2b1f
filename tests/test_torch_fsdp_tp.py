"""Fully sharded data parallelism and tensor parallelism of the port
(``parallel/{mesh,sharding,collectives}.py``, the sharded ``Decoder``,
``train_step.py``'s sharded step) against the JAX package.

- The layout: each parameter's global index on each rank
  (``decoder.param_layout``) equals the JAX
  ``NamedSharding(mesh, spec).devices_indices_map(shape)`` at that
  mesh coordinate, and the port's ``shardings_for_tree`` spec the JAX
  one, for a test-size llama (GQA, 4 heads over 2 KV heads) and gpt2
  (tied, learned positions, layernorm) on dp2×fsdp2×tp2 (8 of the 8 CPU
  devices), fsdp4 and tp4 (4).
- The init: ``init_train_state`` at fsdp2×tp2, each rank's shards
  gathered, equals the one-process init bit for bit.
- The stream: 3 steps of ``TrainStepBuilder`` in 4 gloo processes
  (``tests/torch_fsdp_tp_worker.py``) at fsdp2×tp2 (llama) and
  dp2×tp2 with ``grad_accum`` 2 (llama), each on the fused and the
  unfused CE, and fsdp4 and fsdp2×tp2 (gpt2: the tied table serves the
  vocab-parallel lookup and head), from the JAX ``init_train_state``
  on the same mesh, each rank given its rows. Held to the JAX
  ``TrainStepBuilder`` on that mesh (its unfused head under tp): losses
  within 1e-5 relative, grad norms within 1e-4, gathered parameters and
  AdamW moments within 1e-4 of their scale (``test_torch_zero.py``'s
  tolerances: the reductions reorder f32 sums, which Adam's first
  updates amplify where v is small).
- ``Trainer(mesh=MeshConfig(fsdp=2, tp=2))`` over the same batches
  from the same JAX weights: its losses and state held to the JAX step
  as above, and its evaluation at the end (each rank its rows, the
  sums over dp × fsdp) equal to the JAX ``loss_fn`` on the JAX step's
  final parameters within 1e-5 relative, and ``decoder.forward``'s
  whole-vocab logits (gathered over tp) to the JAX ``forward``'s on the
  rank's rows within 1e-4 of their scale.
- Negative controls: the fsdp2×tp2 stream with the norm scales'
  gradients summed over tp (doubled), and with ``wk``/``wv``'s not
  summed over tp (partial), each falls outside those bounds.
- Refusals: pp and ep raise, naming their ROADMAP item (A16); sp with
  fsdp or tp is accepted (its streams: ``tests/test_torch_mesh4d.py``);
  a tp that does not divide ``n_head`` runs on GSPMD's padded head
  blocks, and the splits the JAX placement refuses (a leaf dim its axes
  do not divide: ``d_ff`` or ``vocab_size`` over tp, ``d_model`` over
  fsdp) raise ``ValueError`` citing that refusal. ZeRO update sharding on a dp × fsdp or dp
  × tp mesh resolves to the JAX hybrid plan on the f32 wire, and falls
  back with the JAX reason on a quantized wire (its stream:
  ``tests/test_torch_hybrid_zero.py``).
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_sp_worker  # noqa: E402
from dlrover_tpu.models import decoder as jdec  # noqa: E402
from dlrover_tpu.models.config import get_config as jget  # noqa: E402
from dlrover_tpu.parallel import MeshConfig, build_mesh  # noqa: E402
from dlrover_tpu.parallel import sharding as jshd  # noqa: E402
from dlrover_tpu.train import optimizer as jopt  # noqa: E402
from dlrover_tpu.train import train_step as jts  # noqa: E402
from dlrover_tpu_torch.models import convert  # noqa: E402
from dlrover_tpu_torch.models import decoder as tdec  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from dlrover_tpu_torch.parallel import sharding as tshd  # noqa: E402
from dlrover_tpu_torch.train import optimizer as topt  # noqa: E402
from dlrover_tpu_torch.train import train_step as tts  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_fsdp_tp_worker.py")
_LLAMA = ("tiny", dict(n_layer=2, d_model=64, n_head=4, n_kv_head=2,
                       d_ff=128, vocab_size=256, max_seq=32,
                       tie_embeddings=False, dtype="float32"))
_GPT2 = ("gpt2-124m", dict(n_layer=2, d_model=64, n_head=4, d_ff=128,
                           vocab_size=256, max_seq=32, dtype="float32"))
_OPT = dict(learning_rate=1e-3, weight_decay=0.1, warmup_steps=2,
            decay_steps=20, grad_clip=1.0)
B, S, STEPS = 8, 32, 3
_MESHES = {"dp2fsdp2tp2": dict(dp=2, fsdp=2, tp=2), "fsdp4": dict(fsdp=4),
           "tp4": dict(tp=4)}
# id: (model, mesh, grad_accum, fused CE, planted fault)
_CASES = {
    "fsdp2tp2_fused": (_LLAMA, dict(fsdp=2, tp=2), 1, True, None),
    "fsdp2tp2_unfused": (_LLAMA, dict(fsdp=2, tp=2), 1, False, None),
    "dp2tp2_accum2_fused": (_LLAMA, dict(dp=2, tp=2), 2, True, None),
    "dp2tp2_accum2_unfused": (_LLAMA, dict(dp=2, tp=2), 2, False, None),
    "fsdp4_gpt2": (_GPT2, dict(fsdp=4), 1, True, None),
    "fsdp2tp2_gpt2": (_GPT2, dict(fsdp=2, tp=2), 1, True, None),
    "trainer_fsdp2tp2": (_LLAMA, dict(fsdp=2, tp=2), 1, True, None),
    "fault_norm_tp": (_LLAMA, dict(fsdp=2, tp=2), 1, True, "norm_tp"),
    "fault_kv_no_tp": (_LLAMA, dict(fsdp=2, tp=2), 1, True, "kv_no_tp"),
}


def _cfgs(which, **over):
    name, kw = which
    kw = dict(kw, **over)
    return jget(name, **kw), get_config(name, **kw)


def _jmesh(kw):
    n = int(np.prod(list(kw.values())))
    return build_mesh(MeshConfig(**kw), devices=jax.devices()[:n])


def _batches(n=STEPS, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(0, 256, size=(B, S + 1)).astype(np.int32)
        mask = (np.arange(S)[None] < rng.integers(8, S + 1, size=B)[:, None])
        out.append({"tokens": tok[:, :-1], "targets": tok[:, 1:],
                    "mask": mask.astype(np.float32)})
    return out


def _close(port, ref, tol=1e-4):
    port, ref = np.asarray(port), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol * scale)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


# ---- the layout ---------------------------------------------------------


@pytest.mark.parametrize("mesh_id", sorted(_MESHES))
@pytest.mark.parametrize("which", [_LLAMA, _GPT2], ids=["llama", "gpt2"])
def test_param_index_is_the_jax_devices_indices_map(which, mesh_id):
    jcfg, cfg = _cfgs(which)
    mesh = _jmesh(_MESHES[mesh_id])
    sizes = dict(mesh.shape)
    jaxes = jdec.logical_axes(jcfg)
    jspecs = jshd.shardings_for_tree(mesh, jaxes)
    shapes = jax.eval_shape(lambda: jdec.init(jax.random.key(0), jcfg))
    tspecs = tshd.shardings_for_tree(sizes, tdec.logical_axes(cfg))
    assert tdec.logical_axes(cfg) == jaxes
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    rows = {path: (name, stacked)
            for path, name, stacked, _ in tdec.param_table(cfg)}
    for path, sharding in _leaves(jspecs):
        assert tuple(sharding.spec) == tuple(P(*convert._get(tspecs, path))), \
            path
        shape = convert._get(shapes, path).shape
        name, stacked = rows[path]
        want = sharding.devices_indices_map(shape)
        for dev, idx in want.items():
            rank = int(dev.id)
            assert rank in ids
            got = tdec.param_layout(cfg, tmesh.Mesh(sizes, rank))
            for i in range(cfg.n_layer) if stacked else (None,):
                shard = got[name.format(i) if stacked else name]
                full = [[s.start or 0, shape[d] if s.stop is None else s.stop]
                        for d, s in enumerate(idx)]
                if stacked:
                    full = full[1:]
                # the port cuts parameters over fsdp and tp only: under
                # dp x sp the learned position table stays whole
                assert [list(x) for x in shard.index] == full, (path, rank)


def test_init_at_fsdp2_tp2_gathers_to_the_one_process_init_bitwise():
    for which in (_LLAMA, _GPT2):
        _, cfg = _cfgs(which)
        sizes = tmesh.MeshConfig(fsdp=2, tp=2).resolved_sizes(4)
        tx = topt.make_optimizer(**_OPT)
        ranks = [tts.init_train_state(3, cfg, tx, device="cpu",
                                      mesh=tmesh.Mesh(sizes, r))
                 for r in range(4)]
        for st in ranks:
            assert st["params"].mesh is not None
            layout = st["params"].layout
            for n, p in st["params"].named_parameters():
                assert tuple(p.shape) == layout[n].port_shape, n
                assert st["opt_state"]["m"][n].shape == p.shape
        got = convert.gather_jax_tree(
            [dict(st["params"].named_parameters()) for st in ranks], cfg,
            sizes)
        one = tts.init_train_state(3, cfg, tx, device="cpu")
        want = convert.jax_tree_from_state_dict(
            dict(one["params"].named_parameters()), cfg)
        for path, a in _leaves(want):
            np.testing.assert_array_equal(
                convert._get(got, path).view(np.uint32), a.view(np.uint32),
                err_msg=path)


# ---- the stream ---------------------------------------------------------


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """The JAX runs (one a mesh and accumulation: the JAX step takes its
    unfused head under tp whatever ``fused_ce`` says) and the port's,
    every case in one spawn of 4 ranks."""
    batches = _batches()
    held_out = _batches(1, seed=12)[0]
    inits, jax_runs, cases = {}, {}, []
    for cid, (which, mkw, accum, fused, fault) in _CASES.items():
        jcfg, _ = _cfgs(which, fused_ce=fused)
        key = (which[0], tuple(sorted(mkw.items())), accum,
               fused and mkw.get("tp", 1) == 1)
        if key not in jax_runs:
            mesh = _jmesh(mkw)
            jtx = jopt.make_optimizer(**_OPT)
            state = jts.init_train_state(jax.random.key(4), jcfg, mesh, jtx)
            inits[key] = jax.tree.map(np.asarray, state["params"])
            step = jts.TrainStepBuilder(jcfg, mesh, jtx,
                                        grad_accum=accum).build()
            losses, norms = [], []
            for b in batches:
                state, m = step(state, jax.tree.map(jnp.asarray, b))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            eval_loss = float(jdec.loss_fn(state["params"], jax.tree.map(
                jnp.asarray, held_out), jcfg)[0])
            eval_logits = np.asarray(jdec.forward(
                state["params"], jnp.asarray(held_out["tokens"]), jcfg))
            jax_runs[key] = {
                "losses": losses, "grad_norms": norms, "eval": eval_loss,
                "logits": eval_logits,
                "params": jax.tree.map(np.asarray, state["params"]),
                "mu": jax.tree.map(np.asarray, state["opt_state"][1][0].mu),
                "nu": jax.tree.map(np.asarray, state["opt_state"][1][0].nu)}
        cases.append({"id": cid, "cfg": (which[0], dict(which[1],
                                                          fused_ce=fused)),
                      "mesh": mkw, "accum": accum, "fault": fault,
                      "params": inits[key], "ref": key,
                      "trainer": cid.startswith("trainer")})
    spec = {"cases": [{k: v for k, v in c.items() if k != "ref"}
                      for c in cases],
            "opt": _OPT, "batches": [{k: torch.from_numpy(v) for k, v in
                                      b.items()} for b in batches],
            "eval": {k: torch.from_numpy(v) for k, v in held_out.items()}}
    tmp = tmp_path_factory.mktemp("fsdp_tp")
    spec["output_dir"] = str(tmp / "out")
    ranks = torch_sp_worker.spawn("train", spec, 4, tmp, script=WORKER)
    return {c["id"]: (jax_runs[c["ref"]], [r[c["id"]] for r in ranks])
            for c in cases}


def _errors(cid, streams):
    """(loss, grad norm, params, moments) errors of a case: the largest
    relative loss and norm errors, and the parameters' and moments'
    largest error over their scale."""
    ref, ranks = streams[cid]
    which = _CASES[cid][0]
    _, cfg = _cfgs(which)
    sizes = tmesh.MeshConfig(**_CASES[cid][1]).resolved_sizes(4)
    loss = max(float(np.max(np.abs(np.subtract(r["losses"], ref["losses"]))
                            / np.abs(ref["losses"]))) for r in ranks)
    norm = max((float(np.max(np.abs(np.subtract(r["grad_norms"],
                                                ref["grad_norms"]))
                             / np.abs(ref["grad_norms"])))
                for r in ranks if r["grad_norms"]), default=0.0)
    errs = {}
    for key, jkey in (("params", "params"), ("m", "mu"), ("v", "nu")):
        got = convert.gather_jax_tree([r[key] for r in ranks], cfg, sizes)
        worst = 0.0
        for path, want in _leaves(ref[jkey]):
            scale = max(float(np.abs(want).max()), 1e-12)
            worst = max(worst, float(np.abs(convert._get(got, path)
                                            - want).max()) / scale)
        errs[key] = worst
    return loss, norm, errs


@pytest.mark.parametrize("cid", [c for c in _CASES if not
                                 c.startswith("fault")])
def test_sharded_stream_matches_the_jax_step_on_the_same_mesh(streams, cid):
    ref, ranks = streams[cid]
    for rank, r in enumerate(ranks):
        assert {k: v for k, v in r["mesh"].items() if v > 1} == \
            _CASES[cid][1]
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5)
        if cid.startswith("trainer"):
            np.testing.assert_allclose(r["evals"][:1], [ref["eval"]],
                                       rtol=1e-5)
            # decoder.forward's whole-vocab logits (gathered over tp) on
            # this rank's rows
            got = r["evals"][1].numpy()
            rows = got.shape[0]
            start = rows * (rank // _CASES[cid][1]["tp"])
            _close(got, ref["logits"][start:start + rows])
            continue
        np.testing.assert_allclose(r["grad_norms"], ref["grad_norms"],
                                   rtol=1e-4)
    loss, norm, errs = _errors(cid, streams)
    assert errs["params"] <= 1e-4 and errs["m"] <= 1e-4 \
        and errs["v"] <= 1e-4, errs


@pytest.mark.parametrize("fault", ["fault_norm_tp", "fault_kv_no_tp"])
def test_a_wrong_gradient_reduction_falls_outside_the_bounds(streams, fault):
    loss, norm, errs = _errors(fault, streams)
    ok_loss, ok_norm, ok_errs = _errors("fsdp2tp2_fused", streams)
    assert ok_norm <= 1e-4 and max(ok_errs.values()) <= 1e-4
    assert norm > 1e-4 or loss > 1e-5 or max(errs.values()) > 1e-4, (
        loss, norm, errs)
    # the grad norm alone catches both (the bound the chip gate reads):
    # doubled norm-scale gradients grow it, partial KV gradients shrink it
    assert norm > 1e-4, norm


# ---- refusals -----------------------------------------------------------


@pytest.mark.parametrize("kw,item", [
    (dict(sp=2, fsdp=2), None), (dict(sp=2, tp=2), None),
    (dict(pp=2, fsdp=2), "A16"), (dict(ep=2, tp=2), "A16")])
def test_unported_combinations_raise_naming_their_item(kw, item):
    """pp and ep raise naming A16; sp with fsdp or tp is accepted (item
    None): the sharded model builds, and in one process the step refuses
    only the mesh's four ranks (its streams: test_torch_mesh4d.py)."""
    sizes = tmesh.MeshConfig(**kw).resolved_sizes(4)
    _, cfg = _cfgs(_LLAMA)
    if item is None:
        tmesh.check_ported(sizes)
        model = tdec.Decoder(cfg, device="meta", trainable=True,
                             mesh=tmesh.Mesh(sizes, 0))
        assert model.mesh is not None
        with pytest.raises(ValueError, match="the world has 1"):
            tts.TrainStepBuilder(cfg, topt.make_optimizer(**_OPT),
                                 device="cpu", mesh=tmesh.Mesh(sizes, 0))
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tmesh.check_ported(sizes)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tts.TrainStepBuilder(cfg, topt.make_optimizer(**_OPT), device="cpu",
                             mesh=tmesh.Mesh(sizes, 0))


@pytest.mark.parametrize("over,kw", [
    (dict(n_head=6, n_kv_head=2, d_model=96), dict(tp=4)),
    (dict(d_ff=130), dict(tp=4)), (dict(vocab_size=254), dict(tp=4)),
    (dict(d_model=66, n_head=2, n_kv_head=1), dict(fsdp=4))])
def test_uneven_splits_raise_naming_a9(over, kw):
    """A tp that does not divide ``n_head`` (6 heads, 96 q columns over
    tp 4) runs on GSPMD's padded head blocks (rank 1: heads 2 and 3, its
    24 columns resharded to them); the leaf splits the JAX placement
    refuses raise ``ValueError`` citing that refusal."""
    _, cfg = _cfgs(_LLAMA, **over)
    mesh = tmesh.Mesh(tmesh.MeshConfig(**kw).resolved_sizes(4), 1)
    if over.get("n_head") == 6:
        model = tdec.Decoder(cfg, device="meta", trainable=True, mesh=mesh)
        assert (model.tp.mode, model.tp.heads) == ("heads", 2)
        assert model.tp.head_cols[1] == (32, 64) and \
            model.tp.cols[1] == (24, 48)
        # one process refuses only the mesh's four ranks
        with pytest.raises(ValueError, match="the world has 1"):
            tts.TrainStepBuilder(cfg, topt.make_optimizer(**_OPT),
                                 device="cpu", mesh=mesh)
        return
    with pytest.raises(ValueError, match="JAX package refuses"):
        tdec.Decoder(cfg, device="meta", trainable=True, mesh=mesh)
    with pytest.raises(ValueError, match="JAX package refuses"):
        tts.TrainStepBuilder(cfg, topt.make_optimizer(**_OPT), device="cpu",
                             mesh=mesh)


def test_data_axes_and_the_rows_of_a_rank_are_the_jax_batch_shard():
    assert tmesh.data_axes() == ("dp", "fsdp")
    mesh = _jmesh(dict(dp=2, fsdp=2, tp=2))
    tokens = np.arange(8 * 4, dtype=np.int32).reshape(8, 4)
    arr = jax.device_put(tokens, jts.batch_sharding(mesh))
    for shard in arr.addressable_shards:
        mine = torch_sp_worker.local_batch(
            {"tokens": tokens}, tmesh.Mesh(dict(mesh.shape),
                                           shard.device.id))
        np.testing.assert_array_equal(mine["tokens"].numpy(),
                                      np.asarray(shard.data))


@pytest.mark.parametrize("kw,axes", [(dict(dp=2, fsdp=2), ("fsdp",)),
                                     (dict(dp=2, tp=2), ("tp",))])
def test_zero_on_a_sharded_mesh_falls_back_with_its_reason(kw, axes):
    """ZeRO on dp × fsdp and dp × tp is active on the f32 wire, its plan
    the JAX hybrid plan (global leaves, ``mesh_axes`` dp and the axis in
    use); a quantized wire there falls back with the JAX reason."""
    jcfg, cfg = _cfgs(_LLAMA)
    sizes = tmesh.MeshConfig(**kw).resolved_sizes(4)
    params = dict(tdec.Decoder(cfg, device="meta",
                               trainable=True).named_parameters())
    mesh = tmesh.Mesh(sizes, 0)
    active, reason, plan = tshd.resolve_update_sharding(
        cfg, params, 4, tshd.CommConfig(update_sharding=True), mesh)
    assert (active, reason) == (True, None)
    abs_ = jax.eval_shape(lambda: jdec.init(jax.random.key(0), jcfg))
    want = jshd.build_pack_plan(abs_, 2, tshd.CommConfig().bucket_bytes,
                                mesh_axes=("dp",) + axes)
    for field in ("shapes", "sizes", "offsets", "total", "bucket_elems",
                  "n_buckets", "dp", "tie_size", "n_tie_buckets",
                  "mesh_axes"):
        assert getattr(plan, field) == getattr(want, field), field
    jm = _jmesh(kw)
    for wire in ("bfloat16", "int8"):
        comm = tshd.CommConfig(update_sharding=True, wire_dtype=wire)
        got = tshd.resolve_update_sharding(cfg, params, 4, comm, mesh)
        ref = jts.resolve_update_sharding(
            jcfg, jm, jopt.make_optimizer(**_OPT),
            jshd.CommConfig(update_sharding=True, wire_dtype=wire))
        assert got[:2] == ref[:2] and not got[0] and "pure-dp" in got[1]
