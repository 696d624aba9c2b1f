"""Sequence parallelism with fsdp and tp, and tensor parallelism over a
head count tp does not divide, in the port (``parallel/mesh.py``'s dp ×
fsdp × sp × tp groups, ``decoder.TpPlan``, ``collectives.tp_reshard``,
``sequence.head_axis``, ``train_step.py``'s sharded step with sp)
against the JAX package on the same mesh.

- The layout: at dp 1 × fsdp 2 × sp 2 × tp 2 (8 CPU devices) every
  parameter's global index on every rank (``decoder.param_layout``) is
  the JAX ``NamedSharding.devices_indices_map`` of its leaf, but for the
  learned position table, which the JAX rules cut over sp (``("seq",
  "embed")``) and the port keeps whole over sp (``PARAM_CUT_AXES``: each
  sp rank reads its block's rows of the whole table): there the port's
  index is JAX's with the seq dim whole.
- The plan: ``TpPlan`` gives GSPMD's padded head blocks where tp does
  not divide ``n_head`` (gpt2-1.5b: 13 + 12 heads on tp 2, 7/7/7/4 on tp
  4; each rank's ``wq`` columns still the leaf's column block), and
  every head to every tp rank under sp where tp does not divide both
  head counts (the JAX ``_head_axis``).
- The stream: 2 steps of ``TrainStepBuilder`` in one spawn of 4 gloo
  processes (``tests/torch_fsdp_tp_worker.py``) from the JAX
  ``init_train_state`` on the same mesh, each rank given its rows: sp 2
  × tp 2 (llama GQA: ring and Ulysses; with one KV head, where every tp
  rank attends over all heads), fsdp 2 × sp 2 (gpt2: tied, learned
  positions; ring), tp 4 with 6 heads over 2 KV heads (1.5 heads of
  columns a rank), fsdp 2 × tp 2 with a 3-head gpt2, and
  ``Trainer(mesh=MeshConfig(sp=2, tp=2))``. Held to the JAX
  ``TrainStepBuilder`` on that mesh with the same ``attn_impl``:
  losses within 1e-5 relative, grad norms within 1e-4, gathered
  parameters and AdamW moments within 1e-4 of their scale
  (``test_torch_fsdp_tp.py``'s tolerances); the Trainer's evaluation
  at the end within 1e-5 of the JAX ``loss_fn`` on the JAX step's
  final parameters.
- Negative controls: sp 2 × tp 2 with the norm scales' gradients not
  summed over sp, and fsdp 2 × tp 2 (3 heads) with the q move's
  backward leaving out the straddling head's returned half, each fall
  outside those bounds.
- Packs: a ``Trainer`` at sp 2 × tp 2 saves each rank's pack; the packs
  restore bit for bit at sp 2 × tp 2 (memory and storage), at fsdp 2 ×
  tp 2 and in one process.
"""

import os
import uuid

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
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
from dlrover_tpu_torch.parallel import sequence as tseq  # noqa: E402
from dlrover_tpu_torch.parallel import sharding as tshd  # noqa: E402
from dlrover_tpu_torch.train import optimizer as topt  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_fsdp_tp_worker.py")
_BASE = dict(n_layer=2, d_ff=128, vocab_size=256, max_seq=32,
             dtype="float32")
_LLAMA = ("tiny", dict(_BASE, d_model=64, n_head=4, n_kv_head=2,
                       tie_embeddings=False))
_LLAMA_KV1 = ("tiny", dict(_LLAMA[1], n_kv_head=1))
_LLAMA_6H = ("tiny", dict(_LLAMA[1], d_model=96, n_head=6, n_kv_head=2))
_GPT2 = ("gpt2-124m", dict(_BASE, d_model=64, n_head=4))
_GPT2_3H = ("gpt2-124m", dict(_BASE, d_model=96, n_head=3))
_OPT = dict(learning_rate=1e-3, weight_decay=0.1, warmup_steps=2,
            decay_steps=20, grad_clip=1.0)
B, S, STEPS = 8, 32, 2
# id: (model, mesh, attn_impl, planted fault)
_CASES = {
    "sp2tp2_ring": (_LLAMA, dict(sp=2, tp=2), "ring", None),
    "sp2tp2_ulysses": (_LLAMA, dict(sp=2, tp=2), "ulysses", None),
    "sp2tp2_kv1_ring": (_LLAMA_KV1, dict(sp=2, tp=2), "ring", None),
    "fsdp2sp2_gpt2_ring": (_GPT2, dict(fsdp=2, sp=2), "ring", None),
    "tp4_6heads": (_LLAMA_6H, dict(tp=4), "auto", None),
    "fsdp2tp2_gpt2_3heads": (_GPT2_3H, dict(fsdp=2, tp=2), "auto", None),
    "trainer_sp2tp2": (_LLAMA, dict(sp=2, tp=2), "ring", None),
    "fault_norm_no_sp": (_LLAMA, dict(sp=2, tp=2), "ring", "norm_no_sp"),
    "fault_reshard_drop": (_GPT2_3H, dict(fsdp=2, tp=2), "auto",
                           "reshard_drop"),
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


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


# ---- the layout and the plan --------------------------------------------


@pytest.mark.parametrize("which", [_LLAMA, _GPT2], ids=["llama", "gpt2"])
def test_param_index_at_fsdp2_sp2_tp2_is_the_jax_devices_indices_map(which):
    jcfg, cfg = _cfgs(which)
    mesh = _jmesh(dict(dp=1, fsdp=2, sp=2, tp=2))
    sizes = dict(mesh.shape)
    jspecs = jshd.shardings_for_tree(mesh, jdec.logical_axes(jcfg))
    shapes = jax.eval_shape(lambda: jdec.init(jax.random.key(0), jcfg))
    tspecs = tshd.shardings_for_tree(sizes, tdec.logical_axes(cfg))
    rows = {path: (name, stacked)
            for path, name, stacked, _ in tdec.param_table(cfg)}
    seen_pos = False
    for path, sharding in _leaves(jspecs):
        assert tuple(sharding.spec) == tuple(P(*convert._get(tspecs, path))), \
            path
        shape = convert._get(shapes, path).shape
        name, stacked = rows[path]
        for dev, idx in sharding.devices_indices_map(shape).items():
            got = tdec.param_layout(cfg, tmesh.Mesh(sizes, int(dev.id)))
            full = [[s.start or 0, shape[d] if s.stop is None else s.stop]
                    for d, s in enumerate(idx)]
            if path == "pos_embed/table":
                # cut over sp by the JAX rules, whole over sp in the port
                assert sharding.spec[0] == "sp"
                full[0] = [0, shape[0]]
                seen_pos = True
            if stacked:
                full = full[1:]
            for i in range(cfg.n_layer) if stacked else (None,):
                shard = got[name.format(i) if stacked else name]
                assert [list(x) for x in shard.index] == full, (path, dev.id)
    assert seen_pos == (cfg.pos == "learned")


@pytest.mark.parametrize("tp,heads", [(2, [13, 12]), (4, [7, 7, 7, 4])])
def test_gpt2_1_5b_heads_are_gspmd_padded_blocks(tp, heads):
    cfg = get_config("gpt2-1.5b")
    sizes = tmesh.MeshConfig(tp=tp).resolved_sizes(tp)
    width = cfg.n_head * cfg.head_dim // tp
    for r in range(tp):
        plan = tdec.tp_plan(cfg, tmesh.Mesh(sizes, r), "cpu")
        assert plan.mode == "heads" and plan.heads == heads[r]
        assert plan.kv_heads == heads[r]
        assert plan.cols[r] == (r * width, (r + 1) * width)
        first = sum(heads[:r]) * cfg.head_dim
        assert plan.head_cols[r] == (first, first + heads[r] * cfg.head_dim)
        assert plan.kv_rows == slice(*plan.head_cols[r])
        layout = tdec.param_layout(cfg, tmesh.Mesh(sizes, r))
        assert layout["layers.0.attn.wq.weight"].index == (
            (0, cfg.d_model), (r * width, (r + 1) * width))


@pytest.mark.parametrize("n_kv,mode", [(2, "even"), (1, "all")])
def test_sp_keeps_heads_over_tp_only_where_tp_divides_both(n_kv, mode):
    _, cfg = _cfgs(_LLAMA, n_kv_head=n_kv)
    sizes = tmesh.MeshConfig(sp=2, tp=2).resolved_sizes(4)
    assert tseq.head_axis(sizes, cfg.n_head, n_kv) == (
        "tp" if mode == "even" else None)
    plan = tdec.tp_plan(cfg, tmesh.Mesh(sizes, 1), "cpu")
    assert plan.mode == mode
    assert plan.heads == (cfg.n_head // 2 if mode == "even" else cfg.n_head)


def test_zero_on_a_mesh_with_sp_falls_back_with_the_jax_reason():
    jcfg, cfg = _cfgs(_LLAMA)
    kw = dict(dp=2, sp=2, tp=2)
    sizes = tmesh.MeshConfig(**kw).resolved_sizes(8)
    params = dict(tdec.Decoder(cfg, device="meta",
                               trainable=True).named_parameters())
    got = tshd.resolve_update_sharding(
        cfg, params, 8, tshd.CommConfig(update_sharding=True),
        tmesh.Mesh(sizes, 0))
    want = jts.resolve_update_sharding(
        jcfg, _jmesh(kw), jopt.make_optimizer(**_OPT),
        jshd.CommConfig(update_sharding=True))
    assert got[:2] == tuple(want[:2]) and not got[0] and "sp" in got[1]


# ---- the stream ---------------------------------------------------------


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """The JAX runs (one a model, mesh and attn_impl) and the port's,
    every case in one spawn of 4 ranks."""
    batches = _batches()
    held_out = _batches(1, seed=12)[0]
    inits, jax_runs, cases = {}, {}, []
    for cid, (which, mkw, impl, fault) in _CASES.items():
        jcfg, _ = _cfgs(which)
        key = (which[0], tuple(sorted(which[1].items())),
               tuple(sorted(mkw.items())), impl)
        if key not in jax_runs:
            mesh = _jmesh(mkw)
            jtx = jopt.make_optimizer(**_OPT)
            state = jts.init_train_state(jax.random.key(4), jcfg, mesh, jtx)
            inits[key] = jax.tree.map(np.asarray, state["params"])
            step = jts.TrainStepBuilder(jcfg, mesh, jtx,
                                        attn_impl=impl).build()
            losses, norms = [], []
            for b in batches:
                state, m = step(state, jax.tree.map(jnp.asarray, b))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            eval_loss = float(jdec.loss_fn(state["params"], jax.tree.map(
                jnp.asarray, held_out), jcfg)[0])
            jax_runs[key] = {
                "losses": losses, "grad_norms": norms, "eval": eval_loss,
                "params": jax.tree.map(np.asarray, state["params"]),
                "mu": jax.tree.map(np.asarray, state["opt_state"][1][0].mu),
                "nu": jax.tree.map(np.asarray, state["opt_state"][1][0].nu)}
        cases.append({"id": cid, "cfg": which, "mesh": mkw, "accum": 1,
                      "attn_impl": impl, "fault": fault,
                      "params": inits[key], "ref": key,
                      "trainer": cid.startswith("trainer")})
    spec = {"cases": [{k: v for k, v in c.items() if k != "ref"}
                      for c in cases],
            "opt": _OPT, "batches": [{k: torch.from_numpy(v) for k, v in
                                      b.items()} for b in batches],
            "eval": {k: torch.from_numpy(v) for k, v in held_out.items()}}
    tmp = tmp_path_factory.mktemp("mesh4d")
    spec["output_dir"] = str(tmp / "out")
    ranks = torch_sp_worker.spawn("train", spec, 4, tmp, script=WORKER)
    return {c["id"]: (jax_runs[c["ref"]], [r[c["id"]] for r in ranks])
            for c in cases}


def _errors(cid, streams):
    """(loss, grad norm, {params, m, v}) errors of a case: the largest
    relative loss and norm errors, and the parameters' and moments'
    largest error over their scale (every rank's shards gathered)."""
    ref, ranks = streams[cid]
    _, cfg = _cfgs(_CASES[cid][0])
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
def test_stream_matches_the_jax_step_on_the_same_mesh(streams, cid):
    ref, ranks = streams[cid]
    for r in ranks:
        assert {k: v for k, v in r["mesh"].items() if v > 1} == \
            _CASES[cid][1]
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5)
        if cid.startswith("trainer"):
            np.testing.assert_allclose(r["evals"][:1], [ref["eval"]],
                                       rtol=1e-5)
        else:
            np.testing.assert_allclose(r["grad_norms"], ref["grad_norms"],
                                       rtol=1e-4)
    _, _, errs = _errors(cid, streams)
    assert max(errs.values()) <= 1e-4, errs


@pytest.mark.parametrize("fault,ok", [
    ("fault_norm_no_sp", "sp2tp2_ring"),
    ("fault_reshard_drop", "fsdp2tp2_gpt2_3heads")])
def test_a_planted_fault_falls_outside_the_bounds(streams, fault, ok):
    loss, norm, errs = _errors(fault, streams)
    ok_loss, ok_norm, ok_errs = _errors(ok, streams)
    assert ok_norm <= 1e-4 and max(ok_errs.values()) <= 1e-4
    # the grad norm alone catches each (the bound the chip gate reads)
    assert norm > 1e-4, (loss, norm, errs)


# ---- packs --------------------------------------------------------------


def _assemble(ranks):
    """{path: global array} from every rank's shards (index, values)."""
    out = {}
    for shards in ranks:
        for path, items in shards.items():
            for index, t in items:
                stop = [b for _, b in index]
                if path not in out:
                    out[path] = torch.zeros(stop or [], dtype=t.dtype)
                full = out[path]
                grow = [max(a, b) for a, b in zip(full.shape, stop)]
                if list(full.shape) != grow:
                    bigger = torch.zeros(grow, dtype=t.dtype)
                    bigger[tuple(slice(0, n) for n in full.shape)] = full
                    out[path] = full = bigger
                full[tuple(slice(a, b) for a, b in index)] = t.reshape(
                    [b - a for a, b in index])
    return out


def _same_shards(got, want):
    """Every shard of ``got`` (a rank's) equals ``want`` (global arrays)
    at its index, bit for bit."""
    assert sorted(got) == sorted(want)
    for path, items in got.items():
        for index, t in items:
            ref = want[path][tuple(slice(a, b) for a, b in index)]
            assert torch.equal(t.reshape(ref.shape), ref), path


def test_sp2_tp2_packs_restore_at_fsdp2_tp2_and_in_one_process(
        tmp_path, monkeypatch):
    from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
    from dlrover_tpu_torch.train.trainer import Trainer, TrainerArgs

    # the one-process restore's segment is this test's alone
    monkeypatch.setenv("DLROVER_TPU_RUN_ID", "mesh4d" + uuid.uuid4().hex[:12])

    rng = np.random.default_rng(5)
    batches = []
    for _ in range(2):
        tok = rng.integers(0, 256, size=(8, 33)).astype(np.int64)
        batches.append({"tokens": torch.from_numpy(tok[:, :-1]),
                        "targets": torch.from_numpy(tok[:, 1:])})
    opt = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=20,
               grad_clip=1.0)
    spec = {"cfg": _LLAMA, "mesh": {"sp": 2, "tp": 2}, "opt": opt,
            "batches": batches, "steps": 2, "seed": 3,
            "output_dir": str(tmp_path / "out")}
    for sub in ("a", "b"):
        (tmp_path / sub).mkdir()
    ranks = torch_sp_worker.spawn("trainer", spec, 4, tmp_path / "a",
                                  script=WORKER)
    saved = _assemble([r["saved"] for r in ranks])
    for r in ranks:
        assert {k: v for k, v in r["mesh"].items() if v > 1} == spec["mesh"]
        assert (r["memory_tier"], r["storage_tier"]) == ("memory", "storage")
        _same_shards(r["saved"], saved)
        _same_shards(r["memory"], saved)
        _same_shards(r["storage"], saved)
    # fsdp 2 x tp 2: other shards, from the same four packs
    other = torch_sp_worker.spawn(
        "trainer", dict(spec, mesh={"fsdp": 2, "tp": 2}, restore_only=True),
        4, tmp_path / "b", script=WORKER)
    for r in other:
        assert r["storage_tier"] == "storage"
        _same_shards(r["storage"], saved)
    wq = "params/layers/attn/wq"
    assert sum(t.numel() for _, t in other[0]["storage"][wq]) * 4 == \
        saved[wq].numel()
    # one process: the whole state
    _, cfg = _cfgs(_LLAMA)
    t = Trainer(cfg, TrainerArgs(output_dir=spec["output_dir"], max_steps=2,
                                 save_interval=0, detect_loss_spikes=False,
                                 report_to_master=False, log_interval=0),
                [], topt.make_optimizer(**opt), device="cpu")
    t.train()
    assert t.state["step"] == 2
    assert t.checkpointer.engine.timings[-1]["tier"] == "storage"
    one = {leaf.path: [(s.index, (s.tensor.t() if s.transposed else
                                  s.tensor).detach().clone())
                       for s in leaf.shards] for leaf in t.state_leaves()}
    t.checkpointer.close()
    CheckpointEngine.unlink_segment()
    _same_shards(one, saved)
