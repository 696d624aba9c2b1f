"""ZeRO update sharding on a dp × fsdp and a dp × tp mesh (the hybrid
step of ``train_step.py``), its packs, and the example's
``--hosts-per-slice`` mesh, against the JAX package on the CPU.

- The stream: 3 steps of ``TrainStepBuilder`` with ``CommConfig``
  zero1 and zero2, ``grad_accum`` 1 and 2, on dp2×fsdp2 and dp2×tp2, for
  a test-size llama (GQA) and gpt2 (tied: under tp the table serves the
  vocab-parallel lookup and head), in 4 gloo processes
  (``tests/torch_fsdp_tp_worker.py``), from the JAX
  ``init_train_state`` on the same mesh, each rank given its rows. The
  JAX update-sharded step does not run on these meshes on this jax
  (ROADMAP C), so the reference is the JAX GSPMD step on the same mesh
  without update sharding: ZeRO is the same arithmetic in another
  summation order. ``test_torch_zero.py``'s tolerances: losses within
  1e-5 relative, grad norms within 1e-4, the gathered parameters and
  the flat moments (against the JAX ``pack_flat`` of the JAX moments)
  within 1e-4 of their scale. Every fsdp × tp peer of a dp rank holds
  the same moment columns, bit for bit.
- Negative controls: a leaf (``layers/mlp/w_up``) laid into the global
  gradient stream from one rank's shard, not every fsdp peer's (item a
  of the hybrid step), and the columns' square sums added over the
  whole world instead of dp (item b: the norm counted fsdp × tp times),
  each falls outside those bounds.
- The packs: a ``Trainer`` with zero2 on dp2×fsdp2 saves its packs (the
  flat moments' dp columns, the same on every fsdp peer; the parameters'
  shards); they restore bit for bit at the same layout, in one process
  without ZeRO (the moments cut from the flat stream by
  ``convert.moment_bridge``), at fsdp2×tp2 without ZeRO, and at a
  pure-dp ZeRO layout of the same plan (dp 2).
- The example: ``train_gpt_elastic --hosts-per-slice 2 --zero1`` under
  the port's launcher, 4 CPU ranks, 3 steps: the slice mesh dp 2 × fsdp
  2, update sharding active, every rank's losses and grad norms those
  of one process's replicated step on the same global batches (1e-5 and
  1e-4 relative).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_sp_worker  # noqa: E402
from dlrover_tpu.models.config import get_config as jget  # noqa: E402
from dlrover_tpu.parallel import MeshConfig, build_mesh  # noqa: E402
from dlrover_tpu.parallel import sharding as jshd  # noqa: E402
from dlrover_tpu.train import optimizer as jopt  # noqa: E402
from dlrover_tpu.train import train_step as jts  # noqa: E402
from dlrover_tpu_torch.models import convert  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from dlrover_tpu_torch.train import optimizer as topt  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_fsdp_tp_worker.py")
_LLAMA = ("tiny", dict(n_layer=2, d_model=64, n_head=4, n_kv_head=2,
                       d_ff=128, vocab_size=256, max_seq=32,
                       tie_embeddings=False, dtype="float32"))
_GPT2 = ("gpt2-124m", dict(n_layer=2, d_model=64, n_head=4, d_ff=128,
                           vocab_size=256, max_seq=32, dtype="float32"))
_MODELS = {"llama": _LLAMA, "gpt2": _GPT2}
_MESHES = {"dp2fsdp2": dict(dp=2, fsdp=2), "dp2tp2": dict(dp=2, tp=2)}
_OPT = dict(learning_rate=1e-3, weight_decay=0.1, warmup_steps=2,
            decay_steps=20, grad_clip=1.0)
B, S, STEPS = 8, 32, 3
BUCKET_MB = 0.02
# id: (model, mesh, mode, grad_accum, planted fault)
_CASES = {f"{m}-{mid}-{mode}-a{a}": (m, mid, mode, a, None)
          for m in _MODELS for mid in _MESHES
          for mode in ("zero1", "zero2") for a in (1, 2)}
_FAULTS = {"fault_unassembled": ("llama", "dp2fsdp2", "zero2", 1,
                                 "unassembled"),
           "fault_norm_world": ("llama", "dp2tp2", "zero1", 1,
                                "norm_world")}


def _batches(n=STEPS, seed=13):
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


def _rel(got, want):
    return float(np.max(np.abs(np.subtract(got, want)) / np.abs(want)))


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """The JAX GSPMD runs (one a model, mesh and accumulation) and the
    port's, every case in one spawn of 4 ranks."""
    batches = _batches()
    jax_runs, inits, cases = {}, {}, []
    for cid, (model, mid, mode, accum, fault) in {**_CASES,
                                                  **_FAULTS}.items():
        name, kw = _MODELS[model]
        key = (model, mid, accum)
        if key not in jax_runs:
            jcfg = jget(name, **kw)
            mkw = _MESHES[mid]
            mesh = build_mesh(MeshConfig(**mkw), devices=jax.devices()[:4])
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
            jax_runs[key] = {
                "losses": losses, "grad_norms": norms,
                "params": jax.tree.map(np.asarray, state["params"]),
                "mu": jax.tree.map(np.asarray, state["opt_state"][1][0].mu),
                "nu": jax.tree.map(np.asarray, state["opt_state"][1][0].nu)}
        cases.append({"id": cid, "cfg": _MODELS[model],
                      "mesh": _MESHES[mid], "accum": accum, "fault": fault,
                      "zero": mode, "bucket_mb": BUCKET_MB,
                      "params": inits[key], "ref": key})
    spec = {"cases": [{k: v for k, v in c.items() if k != "ref"}
                      for c in cases],
            "opt": _OPT, "batches": [{k: torch.from_numpy(v) for k, v in
                                      b.items()} for b in batches]}
    tmp = tmp_path_factory.mktemp("hybrid_zero")
    spec["output_dir"] = str(tmp / "out")
    ranks = torch_sp_worker.spawn("train", spec, 4, tmp, script=WORKER,
                                  timeout_s=240)
    return {c["id"]: (jax_runs[c["ref"]], [r[c["id"]] for r in ranks])
            for c in cases}


def _flat_columns(ranks, key, sizes, strict=True):
    """The whole flat leaf from the ranks' dp columns (fsdp × tp peers
    checked equal, bit for bit, when ``strict``) and the plan."""
    plan, _ = ranks[0]["shard"]
    full = torch.zeros(plan.n_buckets, plan.bucket_elems)
    seen = {}
    for rank, r in enumerate(ranks):
        p, d = r["shard"]
        assert p == plan and d == tmesh.rank_coords(rank, sizes)["dp"]
        cols = r[key]["flat"]
        if d in seen and strict:
            assert torch.equal(cols.view(torch.int32),
                               seen[d].view(torch.int32)), (key, rank)
        seen[d] = cols
        full[:, plan.columns(d)] = cols
    assert sorted(seen) == list(range(plan.dp))
    return full.numpy(), plan


def _errors(cid, streams, cases):
    """(loss, grad norm, {params, m, v}) errors of a case: the largest
    relative loss and norm errors over the ranks and steps, and the
    parameters' and moments' largest error over their scale."""
    ref, ranks = streams[cid]
    model, mid = cases[cid][:2]
    name, kw = _MODELS[model]
    cfg = get_config(name, **kw)
    sizes = tmesh.MeshConfig(**_MESHES[mid]).resolved_sizes(4)
    loss = max(_rel(r["losses"], ref["losses"]) for r in ranks)
    norm = max(_rel(r["grad_norms"], ref["grad_norms"]) for r in ranks)
    errs = {}
    got = convert.gather_jax_tree([r["params"] for r in ranks], cfg, sizes)
    errs["params"] = max(
        float(np.abs(convert._get(got, path) - want).max())
        / max(float(np.abs(want).max()), 1e-12)
        for path, want in _leaves(ref["params"]))
    for key, jkey in (("m", "mu"), ("v", "nu")):
        full, plan = _flat_columns(ranks, key, sizes, cases is _CASES)
        jplan = jshd.build_pack_plan(
            jax.tree.map(jnp.asarray, ref[jkey]), plan.dp,
            plan.bucket_elems * 4, tie_embeddings=cfg.tie_embeddings)
        want = np.asarray(jshd.pack_flat(jax.tree.map(jnp.asarray,
                                                      ref[jkey]), jplan))
        errs[key] = float(np.abs(full - want).max()) / max(
            float(np.abs(want).max()), 1e-12)
    return loss, norm, errs


@pytest.mark.parametrize("cid", list(_CASES))
def test_hybrid_zero_stream_matches_the_jax_step_on_the_same_mesh(
        streams, cid):
    ref, ranks = streams[cid]
    for r in ranks:
        assert {k: v for k, v in r["mesh"].items() if v > 1} == \
            _MESHES[_CASES[cid][1]]
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norms"], ref["grad_norms"],
                                   rtol=1e-4)
        plan = r["shard"][0]
        assert plan.mesh_axes == ("dp",) + tuple(
            a for a in ("fsdp", "tp") if _MESHES[_CASES[cid][1]].get(a))
        assert r["m"]["flat"].shape == (plan.n_buckets,
                                        plan.bucket_elems // 2)
    _, _, errs = _errors(cid, streams, _CASES)
    assert max(errs.values()) <= 1e-4, errs


@pytest.mark.parametrize("fault", list(_FAULTS))
def test_a_planted_hybrid_fault_falls_outside_the_bounds(streams, fault):
    loss, norm, errs = _errors(fault, streams, _FAULTS)
    model, mid, mode, accum, _ = _FAULTS[fault]
    ok = f"{model}-{mid}-{mode}-a{accum}"
    ok_loss, ok_norm, ok_errs = _errors(ok, streams, _CASES)
    assert ok_loss <= 1e-5 and ok_norm <= 1e-4 and max(
        ok_errs.values()) <= 1e-4
    # the grad norm alone catches both: a missing peer's shards shrink
    # it, the world-wide square sum grows it
    assert norm > 1e-4, (loss, norm, errs)


# ---- the packs ----------------------------------------------------------


def _assemble(ranks):
    """{path: global array} from every rank's shards (index, values)."""
    out = {}
    for shards in ranks:
        for path, items in shards.items():
            for index, t in items:
                stop = [b for _, b in index]
                full = out.get(path)
                if full is None or any(n < s for n, s in zip(full.shape,
                                                            stop)):
                    grow = torch.zeros(
                        [max(s, 0 if full is None else full.shape[i])
                         for i, s in enumerate(stop)], dtype=t.dtype)
                    if full is not None:
                        grow[tuple(slice(0, n) for n in full.shape)] = full
                    out[path] = full = grow
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


def _per_leaf(saved, cfg, tx):
    """The saved state with each flat moment cut into its leaves: the
    canonical stream (sorted paths, each leaf whole) of the global
    shapes ``param_table`` gives."""
    _, mu, nu = convert.opt_state_paths(tx)
    out = {k: v for k, v in saved.items() if not k.endswith("/flat")}
    for prefix in (mu, nu):
        stream = saved[f"{prefix}/flat"].reshape(-1)
        at = 0
        for path, _, stacked, _ in sorted(convert.param_table(cfg),
                                          key=lambda r: r[0].split("/")):
            shape = list(saved[f"params/{path}"].shape)
            n = int(np.prod(shape))
            out[f"{prefix}/{path}"] = stream[at: at + n].reshape(shape)
            at += n
    return out


@pytest.fixture(scope="module")
def hybrid_packs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hybrid_packs")
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(2):
        tok = rng.integers(0, 256, size=(8, 33)).astype(np.int64)
        batches.append({"tokens": torch.from_numpy(tok[:, :-1]),
                        "targets": torch.from_numpy(tok[:, 1:])})
    spec = {"cfg": _LLAMA, "mesh": {"dp": 2, "fsdp": 2}, "opt": _OPT,
            "batches": batches, "steps": 2, "seed": 3,
            "output_dir": str(tmp / "out"), "update_sharding": "zero2",
            "bucket_mb": BUCKET_MB}
    (tmp / "a").mkdir()
    ranks = torch_sp_worker.spawn("trainer", spec, 4, tmp / "a",
                                  script=WORKER, timeout_s=240)
    return spec, ranks, tmp


def test_hybrid_packs_restore_at_the_same_layout(hybrid_packs):
    _, ranks, _ = hybrid_packs
    saved = _assemble([r["saved"] for r in ranks])
    tx = topt.make_optimizer(**_OPT)
    _, mu, _ = convert.opt_state_paths(tx)
    for r in ranks:
        assert r["mesh"]["dp"] == 2 and r["mesh"]["fsdp"] == 2
        assert (r["memory_tier"], r["storage_tier"]) == ("memory", "storage")
        for key in ("saved", "memory", "storage"):
            _same_shards(r[key], saved)
        # a rank packs its dp columns of the flat moments: half of them
        (index, t), = r["saved"][f"{mu}/flat"]
        assert t.numel() * 2 == saved[f"{mu}/flat"].numel()


def test_hybrid_packs_restore_in_one_process_and_at_fsdp2_tp2(
        hybrid_packs):
    from dlrover_tpu_torch.train.trainer import Trainer, TrainerArgs

    spec, ranks, tmp = hybrid_packs
    saved = _assemble([r["saved"] for r in ranks])
    cfg = get_config(_LLAMA[0], **_LLAMA[1])
    tx = topt.make_optimizer(**_OPT)
    want = _per_leaf(saved, cfg, tx)
    t = Trainer(cfg, TrainerArgs(output_dir=spec["output_dir"], max_steps=2,
                                 save_interval=0, detect_loss_spikes=False,
                                 report_to_master=False, log_interval=0),
                [], tx, device="cpu")
    t.train()
    assert t.state["step"] == 2
    assert t.checkpointer.engine.timings[-1]["tier"] == "storage"
    one = {leaf.path: [(s.index, (s.tensor.t() if s.transposed else
                                  s.tensor).detach().clone())
                       for s in leaf.shards] for leaf in t.state_leaves()}
    t.checkpointer.close()
    _same_shards(one, want)
    (tmp / "b").mkdir()
    fsdp_tp = torch_sp_worker.spawn(
        "trainer", dict(spec, mesh={"fsdp": 2, "tp": 2},
                        update_sharding=False, restore_only=True), 4,
        tmp / "b", script=WORKER, timeout_s=240)
    for r in fsdp_tp:
        assert r["storage_tier"] == "storage"
        _same_shards(r["storage"], want)


def test_hybrid_packs_restore_at_pure_dp_zero(hybrid_packs):
    spec, ranks, tmp = hybrid_packs
    saved = _assemble([r["saved"] for r in ranks])
    (tmp / "c").mkdir()
    dp2 = torch_sp_worker.spawn(
        "trainer", dict(spec, mesh={"dp": 2}, restore_only=True), 2,
        tmp / "c", script=WORKER, timeout_s=240)
    for r in dp2:
        assert r["storage_tier"] == "storage"
        _same_shards(r["storage"], saved)


@pytest.mark.parametrize("model", list(_MODELS))
def test_moment_bridge_lays_the_moments_at_the_plans_offsets(model):
    """Exact: per-leaf moments restored into a ZeRO state are a rank's
    columns of ``pack_flat`` of them (the plan's layout, at another dp
    and bucket size than the bridge's own plan), and back."""
    from dlrover_tpu_torch.models import decoder as tdec
    from dlrover_tpu_torch.parallel import sharding as tshd
    from dlrover_tpu_torch.train import train_step as tts

    cfg = get_config(_MODELS[model][0], **_MODELS[model][1])
    tx = topt.make_optimizer(**_OPT)
    params = dict(tdec.Decoder(cfg, device="meta",
                               trainable=True).named_parameters())
    plan = tshd.build_pack_plan(cfg, params, 2, 1 << 14)
    gen = torch.Generator().manual_seed(7)
    per = tts.init_train_state(0, cfg, tx, device="cpu")
    for k in ("m", "v"):
        for t in per["opt_state"][k].values():
            t.copy_(torch.randn(t.shape, generator=gen))
    arrays = convert.train_state_arrays(per, cfg, tx)
    full = {k: tshd.pack_flat(cfg, per["opt_state"][k], plan)
            for k in ("m", "v")}
    for rank in range(2):
        zero = tts.init_train_state(1, cfg, tx, device="cpu")
        zero["opt_state"] = tx.init({"flat": torch.zeros(
            plan.n_buckets, plan.bucket_elems // 2)})
        convert.load_train_state_arrays(zero, arrays, cfg, tx, (plan, rank))
        for k in ("m", "v"):
            assert torch.equal(zero["opt_state"][k]["flat"],
                               full[k][:, plan.columns(rank)])
    _, mu, nu = convert.opt_state_paths(tx)
    flat = {p: a for p, a in arrays.items()
            if not p.startswith((mu + "/", nu + "/"))}
    for k, prefix in (("m", mu), ("v", nu)):
        flat[f"{prefix}/flat"] = full[k].numpy()
    back = tts.init_train_state(1, cfg, tx, device="cpu")
    convert.load_train_state_arrays(back, flat, cfg, tx)
    for k in ("m", "v"):
        for n, t in per["opt_state"][k].items():
            assert torch.equal(back["opt_state"][k][n], t), n


# ---- the example --------------------------------------------------------


_STEP = re.compile(r"\[worker\] step=(\d+) loss=(\S+) rank=(\d+) "
                   r"grad_norm=(\S+) ")
_EX_OVERRIDES = dict(n_layer=2, vocab_size=512, dtype="float32")


def _example_reference(steps, seed=0, batch=8, seq=32, world=4):
    """One process's replicated step on the example's global batches (the
    ranks' rows in rank order) from its init and optimizer."""
    from dlrover_tpu_torch.examples import train_gpt_elastic as ex
    from dlrover_tpu_torch.train.train_step import (
        TrainStepBuilder,
        init_train_state,
    )

    cfg = get_config("tiny", max_seq=seq, **_EX_OVERRIDES)
    opt = topt.make_optimizer(learning_rate=ex.LR, warmup_steps=ex.WARMUP,
                              decay_steps=ex.DECAY)
    state = init_train_state(seed, cfg, opt, device="cpu")
    step = TrainStepBuilder(cfg, opt, device="cpu").build()
    out = []
    for s in range(1, steps + 1):
        parts = [ex.synthetic_batch(seed, s, r, batch // world, seq,
                                    cfg.vocab_size) for r in range(world)]
        state, m = step(state, {k: np.concatenate([p[k] for p in parts])
                                for k in parts[0]})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def test_example_hosts_per_slice_zero1_runs_the_hybrid_step(tmp_path):
    # the sockets in the default directory, named by the run id: a
    # directory under tmp_path can pass the unix-socket path limit
    env = dict(os.environ, DLROVER_TPU_RUN_ID=f"hybrid_{os.getpid()}",
               DLROVER_TPU_COORDINATOR_PORT="0", OMP_NUM_THREADS="1")
    env.pop("DLROVER_TPU_MASTER_ADDR", None)
    cmd = [sys.executable, "-m", "dlrover_tpu_torch.agent.launcher",
           "--nnodes", "1", "--nproc", "4", "--max-restarts", "0", "--",
           sys.executable, "-m",
           "dlrover_tpu_torch.examples.train_gpt_elastic",
           "--model", "tiny", "--steps", "3", "--batch", "8", "--seq", "32",
           "--ckpt-dir", str(tmp_path / "run"), "--ckpt-every", "0",
           "--zero1", "--hosts-per-slice", "2", "--device", "cpu"]
    for k, v in _EX_OVERRIDES.items():
        cmd += ["--override", f"{k}={v!r}".replace("'", '"')]
    proc = subprocess.run(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, timeout=240)
    log = proc.stdout
    assert proc.returncode == 0, log[-4000:]
    assert log.count("[worker] slice mesh: num_slices=2 dp=2 fsdp=2") == 4
    assert "update sharding did not resolve" not in log
    steps = {}
    for m in _STEP.finditer(log):
        steps.setdefault(int(m.group(1)), {})[int(m.group(3))] = (
            float(m.group(2)), float(m.group(4)))
    assert sorted(steps) == [1, 2, 3] and all(
        sorted(v) == [0, 1, 2, 3] for v in steps.values())
    ref = _example_reference(3)
    for s, ranks in steps.items():
        for loss, norm in ranks.values():
            np.testing.assert_allclose(loss, ref[s - 1][0], rtol=1e-5)
            np.testing.assert_allclose(norm, ref[s - 1][1], rtol=1e-4)
