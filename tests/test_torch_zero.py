"""ZeRO update sharding of the port (``parallel/sharding.py``,
``train_step.py``'s update-sharded step) against the JAX package.

- The flat bucket layout: the port's ``PackPlan`` equals the JAX
  ``build_pack_plan``'s field for field, for a test-size llama (untied)
  and gpt2 (tied, learned positions, layernorm) at dp 1, 2, 4 and 8; its
  ``pack_flat`` of the converted parameters equals the JAX ``pack_flat``
  bit for bit; ``unpack_flat`` inverts it.
- The step: zero1 and zero2, ``grad_accum`` 1 and 2, in 2 and 4 gloo
  processes (``tests/torch_zero_worker.py``) on the llama, and in 2 on
  the tied gpt2 (``tie_size`` > 0: the table's lookup and head
  gradients meet in one bucket row), each rank given its rows of the
  global batch as the JAX step lays them out. The JAX ZeRO step
  does not trace on this jax (``ops/fused_ce.py:134``, a scan carry
  under shard_map; ROADMAP C), so the reference is the JAX REPLICATED
  step on the global batch: 3 steps' losses within 1e-5 relative, grad
  norms within 1e-4, parameters and the gathered flat moments (against
  the JAX ``pack_flat`` of the JAX moments) within 1e-4 of their scale —
  ``test_torch_train_step.py``'s stream tolerances: the reduce-scatter
  reorders f32 sums, which Adam's first updates amplify where v is
  small. The port's replicated step at the same world and accumulation
  (``grad_accum > 1`` at world > 1, ported here) is held to the same
  reference, and the ZeRO step to it with the same tolerances.
- The train state: the flat moments' paths and global shapes are those
  of the JAX update-sharded ``init_train_state``; a rank's pack holds its
  columns and the ranks' packs restore the whole state.
- The bf16 and int8 wires: ``tests/test_torch_wire_dtypes.py``; ZeRO
  on dp × fsdp and dp × tp: ``tests/test_torch_hybrid_zero.py``.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_sp_worker  # noqa: E402
from dlrover_tpu.models import decoder as jdec  # noqa: E402
from dlrover_tpu.models.config import get_config as jget  # noqa: E402
from dlrover_tpu.parallel import MeshConfig, build_mesh  # noqa: E402
from dlrover_tpu.parallel import sharding as jshd  # noqa: E402
from dlrover_tpu.parallel.mesh import single_device_mesh  # noqa: E402
from dlrover_tpu.train import optimizer as jopt  # noqa: E402
from dlrover_tpu.train import train_step as jts  # noqa: E402
from dlrover_tpu_torch.checkpoint import core  # noqa: E402
from dlrover_tpu_torch.models import convert  # noqa: E402
from dlrover_tpu_torch.models import decoder as tdec  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.parallel import sharding as shd  # noqa: E402
from dlrover_tpu_torch.train import optimizer as topt  # noqa: E402
from dlrover_tpu_torch.train import train_step as tts  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_zero_worker.py")
_LLAMA = ("tiny", dict(n_layer=2, d_model=64, n_head=4, n_kv_head=2,
                       d_ff=128, vocab_size=256, max_seq=32,
                       tie_embeddings=False, dtype="float32"))
_GPT2 = ("gpt2-124m", dict(n_layer=2, d_model=64, n_head=2, d_ff=128,
                           vocab_size=256, max_seq=32, dtype="float32"))
_OPT = dict(learning_rate=1e-3, weight_decay=0.1, warmup_steps=2,
            decay_steps=20, grad_clip=1.0)
B, S, STEPS = 8, 32, 3
BUCKET_MB = 0.02
CASES = [(mode, a) for mode in ("zero1", "zero2", None) for a in (1, 2)]


def _cfgs(which):
    name, kw = which
    return jget(name, **kw), get_config(name, **kw)


def _batches(n=STEPS, seed=7):
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


def _jparams(jcfg):
    return jax.tree.map(np.asarray, jdec.init(jax.random.key(0), jcfg))


_MODELS = {"llama": _LLAMA, "gpt2": _GPT2}


def _setup(which):
    jcfg, cfg = _cfgs(_MODELS[which])
    params = _jparams(jcfg)
    weights = convert.state_dict_from_jax(params, cfg)
    return jcfg, cfg, params, weights, _batches()


@pytest.fixture(scope="module")
def setup():
    return _setup("llama")


def _jax_ref(setup):
    """The JAX replicated step, 3 steps on the global batches, by
    accumulation."""
    jcfg, _, params, _, batches = setup
    mesh = single_device_mesh()
    out = {}
    for a in (1, 2):
        jtx = jopt.make_optimizer(**_OPT)
        state = jts.init_train_state(jax.random.key(0), jcfg, mesh, jtx)
        state["params"] = jax.tree.map(jnp.asarray, params)
        step = jts.TrainStepBuilder(jcfg, mesh, jtx, grad_accum=a).build()
        losses, norms = [], []
        for b in batches:
            state, m = step(state, jax.tree.map(jnp.asarray, b))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        mu = state["opt_state"][1][0].mu
        nu = state["opt_state"][1][0].nu
        out[a] = {"losses": losses, "grad_norms": norms,
                  "params": jax.tree.map(np.asarray, state["params"]),
                  "mu": jax.tree.map(np.asarray, mu),
                  "nu": jax.tree.map(np.asarray, nu)}
    return out


@pytest.fixture(scope="module")
def jax_refs(setup):
    """The JAX replicated step of each model, computed when first asked
    for."""
    cache = {}

    def get(which):
        if which not in cache:
            model = setup if which == "llama" else _setup(which)
            cache[which] = (model, _jax_ref(model))
        return cache[which]

    return get


@pytest.fixture(scope="module",
                params=[(2, "llama"), (4, "llama"), (2, "gpt2")],
                ids=["2", "4", "2-gpt2"])
def zero_runs(request, jax_refs, tmp_path_factory):
    """(world, the rank results, (setup, JAX reference)) of a model."""
    world, which = request.param
    model_setup, ref = jax_refs(which)
    _, _, _, weights, batches = model_setup
    spec = {"cfg": _MODELS[which], "opt": _OPT, "weights": weights,
            "batches": batches, "cases": CASES, "bucket_mb": BUCKET_MB}
    return world, torch_sp_worker.spawn(
        "zero", spec, world, tmp_path_factory.mktemp(f"zero{world}{which}"),
        script=WORKER), (model_setup, ref)


def _gathered(ranks, key):
    """The whole flat leaf from every rank's columns."""
    return torch.cat([r[key]["flat"] for r in ranks], dim=1).numpy()


# ---- the layout ---------------------------------------------------------


@pytest.mark.parametrize("dp", [1, 2, 4, 8])
@pytest.mark.parametrize("which", [_LLAMA, _GPT2], ids=["llama", "gpt2"])
def test_pack_plan_fields_equal_jax(which, dp):
    jcfg, cfg = _cfgs(which)
    abs_ = jax.eval_shape(lambda: jdec.init(jax.random.key(0), jcfg))
    want = jshd.build_pack_plan(abs_, dp, 1 << 14,
                                tie_embeddings=jcfg.tie_embeddings)
    params = dict(tdec.Decoder(cfg, device="meta",
                               trainable=True).named_parameters())
    got = shd.build_pack_plan(cfg, params, dp, 1 << 14)
    for field in ("shapes", "sizes", "offsets", "total", "bucket_elems",
                  "n_buckets", "dp", "tie_size", "n_tie_buckets",
                  "mesh_axes"):
        assert getattr(got, field) == getattr(want, field), field
    assert (got.tie_size > 0) == cfg.tie_embeddings


@pytest.mark.parametrize("which", [_LLAMA, _GPT2], ids=["llama", "gpt2"])
def test_pack_flat_equals_jax_bitwise_and_unpacks(which):
    jcfg, cfg = _cfgs(which)
    params = _jparams(jcfg)
    want_plan = jshd.build_pack_plan(jax.tree.map(jnp.asarray, params), 4,
                                     1 << 14,
                                     tie_embeddings=jcfg.tie_embeddings)
    want = np.asarray(jshd.pack_flat(jax.tree.map(jnp.asarray, params),
                                     want_plan))
    model = convert.load_jax_params(params, cfg, device="cpu",
                                    trainable=True)
    tensors = dict(model.named_parameters())
    plan = shd.build_pack_plan(cfg, tensors, 4, 1 << 14)
    got = shd.pack_flat(cfg, tensors, plan)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    back = {n: torch.zeros_like(t) for n, t in tensors.items()}
    shd.unpack_flat(cfg, got, back, plan)
    for n, t in tensors.items():
        assert torch.equal(back[n], t), n


def test_update_sharding_falls_back_with_its_reason():
    _, cfg = _cfgs(_LLAMA)
    comm = shd.CommConfig(update_sharding="zero1")
    b = tts.TrainStepBuilder(cfg, topt.make_optimizer(**_OPT), device="cpu",
                             comm=comm)
    assert not b.update_sharding and b.shard is None
    assert b.update_sharding_reason == "mesh has dp<=1"
    params = dict(tdec.Decoder(get_config(_LLAMA[0], **dict(
        _LLAMA[1], param_dtype="bfloat16")), device="meta",
        trainable=True).named_parameters())
    active, reason, _ = shd.resolve_update_sharding(cfg, params, 2, comm)
    assert not active and "non-f32" in reason


# ---- the step -----------------------------------------------------------


def _check_against(got, ref, cfg, plan_key="plan"):
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], ref["grad_norms"],
                               rtol=1e-4)


@pytest.mark.parametrize("mode", ["zero1", "zero2"])
@pytest.mark.parametrize("accum", [1, 2])
def test_zero_step_matches_the_jax_replicated_step(zero_runs, mode, accum):
    world, ranks, ((jcfg, cfg, _, _, _), jax_ref) = zero_runs
    got = [r[(mode, accum)] for r in ranks]
    ref = jax_ref[accum]
    for r in got:
        _check_against(r, ref, cfg)
        tree = convert.jax_tree_from_state_dict(r["params"], cfg)
        for path, name, _, _ in convert.param_table(cfg):
            _close(convert._get(tree, path), convert._get(ref["params"],
                                                          path))
    # every rank holds the same parameters, bit for bit
    for r in got[1:]:
        for n, t in r["params"].items():
            assert torch.equal(t, got[0]["params"][n]), n
    plan = got[0]["plan"]
    assert plan.dp == world and got[0]["m"]["flat"].shape == (
        plan.n_buckets, plan.bucket_elems // world)
    jplan = jshd.build_pack_plan(jax.tree.map(jnp.asarray, ref["params"]),
                                 world, plan.bucket_elems * 4,
                                 tie_embeddings=jcfg.tie_embeddings)
    assert (jplan.tie_size, jplan.n_tie_buckets) == (plan.tie_size,
                                                     plan.n_tie_buckets)
    for key, jkey in (("m", "mu"), ("v", "nu")):
        want = np.asarray(jshd.pack_flat(
            jax.tree.map(jnp.asarray, ref[jkey]), jplan))
        _close(_gathered(got, key), want)


@pytest.mark.parametrize("accum", [1, 2])
def test_replicated_step_at_world_gt_1_matches_jax(zero_runs, accum):
    """``grad_accum > 1`` in a multi-process world, lifted here."""
    _, ranks, ((_, cfg, _, _, _), jax_ref) = zero_runs
    ref = jax_ref[accum]
    for r in ranks:
        got = r[(None, accum)]
        _check_against(got, ref, cfg)
        tree = convert.jax_tree_from_state_dict(got["params"], cfg)
        for path, _, _, _ in convert.param_table(cfg):
            _close(convert._get(tree, path), convert._get(ref["params"],
                                                          path))


@pytest.mark.parametrize("mode", ["zero1", "zero2"])
@pytest.mark.parametrize("accum", [1, 2])
def test_zero_step_matches_the_ports_replicated_step(zero_runs, mode, accum):
    _, ranks, _ = zero_runs
    for r in ranks:
        got, rep = r[(mode, accum)], r[(None, accum)]
        np.testing.assert_allclose(got["losses"], rep["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norms"], rep["grad_norms"],
                                   rtol=1e-4)
        for n, t in got["params"].items():
            _close(t.numpy(), rep["params"][n].numpy())


# ---- the state ----------------------------------------------------------


def test_flat_state_paths_and_shapes_are_the_jax_update_sharded_states():
    jcfg, cfg = _cfgs(_LLAMA)
    comm = jshd.CommConfig(update_sharding=True, bucket_mb=BUCKET_MB)
    mesh = build_mesh(MeshConfig(dp=2), devices=jax.devices()[:2])
    jtx = jopt.make_optimizer(**_OPT)
    jstate = jts.abstract_train_state(jcfg, mesh, jtx, comm=comm)
    want = {jax.tree_util.keystr(kp, simple=True, separator="/"): leaf.shape
            for kp, leaf in jax.tree_util.tree_leaves_with_path(jstate)}
    tx = topt.make_optimizer(**_OPT)
    tcomm = shd.CommConfig(update_sharding=True, bucket_mb=BUCKET_MB)
    b = tts.TrainStepBuilder(cfg, tx, device="cpu", comm=tcomm)
    plan = shd.build_pack_plan(cfg, dict(tdec.Decoder(
        cfg, device="meta", trainable=True).named_parameters()), 2,
        tcomm.bucket_bytes)
    state = tts.init_train_state(0, cfg, tx, device="cpu")
    cols = plan.bucket_elems // 2
    state["opt_state"] = tx.init({"flat": torch.zeros(plan.n_buckets,
                                                       cols)})
    leaves = convert.train_state_leaves(state, cfg, tx, (plan, 1))
    got = {leaf.path: tuple(leaf.global_shape) for leaf in leaves}
    assert got == {k: tuple(v) for k, v in want.items()}
    assert not b.update_sharding  # one process: the builder falls back


def test_kept_parameter_columns_go_after_a_write_to_the_parameters():
    """The update's columns kept for the next step (``_param_columns``)
    are read again from the parameters once anything wrote them (a
    restore), or when they are another state's."""
    _, cfg = _cfgs(_LLAMA)
    tx = topt.make_optimizer(**_OPT)
    state = tts.init_train_state(0, cfg, tx, device="cpu")
    params = dict(state["params"].named_parameters())
    b = tts.TrainStepBuilder(cfg, tx, device="cpu")
    b.plan = shd.build_pack_plan(cfg, params, 2, 1 << 14)
    b.dp_rank = 1
    cols = b._param_columns(params)
    assert torch.equal(cols, shd.pack_flat(cfg, params, b.plan)[
        :, b.plan.columns(1)])
    b._keep_columns(params, cols)
    assert b._param_columns(params) is cols
    other = tts.init_train_state(1, cfg, tx, device="cpu")
    assert b._param_columns(dict(other["params"].named_parameters())) \
        is not cols
    b._keep_columns(params, cols)
    with torch.no_grad():
        params["embed.tokens"].add_(1.0)
    got = b._param_columns(params)
    assert got is not cols and not torch.equal(got, cols)
    assert torch.equal(got, shd.pack_flat(cfg, params, b.plan)[
        :, b.plan.columns(1)])


@pytest.mark.parametrize("fused", [False, True])
def test_the_columns_update_row_by_row_to_the_same_bits(fused):
    """``_update_columns`` (AdamW a bucket row at a time, so its
    temporaries are a row's size) equals one update of the whole shard,
    bit for bit, and counts one step."""
    tx = (topt.fused_adamw(1e-3, weight_decay=0.1, grad_clip=1.0) if fused
          else topt.make_optimizer(**_OPT))
    gen = torch.Generator().manual_seed(0)
    p, g = (torch.randn(5, 1024, generator=gen) for _ in range(2))
    state = tx.init({"flat": p})
    state["m"]["flat"].copy_(torch.randn(5, 1024, generator=gen))
    state["v"]["flat"].copy_(torch.rand(5, 1024, generator=gen))
    rows = {"step": state["step"], "m": {"flat": state["m"]["flat"].clone()},
            "v": {"flat": state["v"]["flat"].clone()}}
    p_rows, norm = p.clone(), torch.tensor(3.0)
    tx.update_({"flat": p}, {"flat": g}, state, norm=norm)
    b = tts.TrainStepBuilder(_cfgs(_LLAMA)[1], tx, device="cpu")
    b._update_columns(p_rows, g, rows, norm)
    assert torch.equal(p_rows, p) and rows["step"] == state["step"] == 1
    for k in ("m", "v"):
        assert torch.equal(rows[k]["flat"], state[k]["flat"])


def test_each_ranks_pack_holds_its_columns_and_they_restore_the_whole():
    _, cfg = _cfgs(_LLAMA)
    tx = topt.make_optimizer(**_OPT)
    params = dict(tdec.Decoder(cfg, device="meta",
                               trainable=True).named_parameters())
    plan = shd.build_pack_plan(cfg, params, 2, 1 << 14)
    gen = torch.Generator().manual_seed(3)
    full = {k: torch.randn(plan.n_buckets, plan.bucket_elems, generator=gen)
            for k in ("m", "v")}
    packs, states = [], []
    for rank in range(2):
        st = tts.init_train_state(0, cfg, tx, device="cpu")
        st["opt_state"] = {"step": 5, **{
            k: {"flat": full[k][:, plan.columns(rank)].clone()}
            for k in ("m", "v")}}
        st["step"] = 5
        leaves = convert.train_state_leaves(st, cfg, tx, (plan, rank))
        entries, payload = core.plan_pack(leaves)
        header = core.header_bytes(5, entries, {}, rank, 2)
        buf = torch.empty(core.pack_size(header, payload), dtype=torch.uint8)
        core.write_pack(buf, leaves, entries, header)
        packs.append(buf)
        states.append(st)
    # the ranks' arrays sum to the global flat leaves
    arrays = [convert.train_state_arrays(st, cfg, tx, (plan, r))
              for r, st in enumerate(states)]
    _, mu, nu = convert.opt_state_paths(tx)
    for key, path in (("m", mu), ("v", nu)):
        np.testing.assert_array_equal(
            arrays[0][f"{path}/flat"] + arrays[1][f"{path}/flat"],
            full[key].numpy())
    # each rank restores its own pack; the global leaves from both packs
    for rank in range(2):
        fresh = tts.init_train_state(1, cfg, tx, device="cpu")
        fresh["opt_state"] = tx.init({"flat": torch.zeros(
            plan.n_buckets, plan.bucket_elems // 2)})
        leaves = convert.train_state_leaves(fresh, cfg, tx, (plan, rank))
        idx = core.PackIndex()
        idx.add_pack(packs[rank])
        core.restore_leaves(leaves, idx)
        idx.close()
        convert.load_scalars(fresh, leaves, tx)
        assert fresh["step"] == 5 and fresh["opt_state"]["step"] == 5
        for k in ("m", "v"):
            assert torch.equal(fresh["opt_state"][k]["flat"],
                               full[k][:, plan.columns(rank)])
    # the JAX state's global flat arrays give each rank its columns
    for rank in range(2):
        fresh = tts.init_train_state(2, cfg, tx, device="cpu")
        fresh["opt_state"] = tx.init({"flat": torch.zeros(
            plan.n_buckets, plan.bucket_elems // 2)})
        glob = dict(arrays[0])
        for key, path in (("m", mu), ("v", nu)):
            glob[f"{path}/flat"] = full[key].numpy()
        convert.load_train_state_arrays(fresh, glob, cfg, tx, (plan, rank))
        for k in ("m", "v"):
            assert torch.equal(fresh["opt_state"][k]["flat"],
                               full[k][:, plan.columns(rank)])
    whole = torch.zeros(plan.n_buckets, plan.bucket_elems)
    idx = core.PackIndex()
    for buf in packs:
        idx.add_pack(buf)
    got = idx.read_slice(f"{mu}/flat", [[0, plan.n_buckets],
                                         [0, plan.bucket_elems]])
    whole.copy_(got.view(torch.float32).view(whole.shape)
                if got.dtype == torch.uint8 else got)
    idx.close()
    assert torch.equal(whole, full["m"])
