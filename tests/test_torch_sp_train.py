"""The port's train step over a dp × sp mesh, against one process and
against the JAX package.

``TrainStepBuilder`` with ``build_mesh(MeshConfig(dp=2, sp=2))`` in 4
gloo processes (``tests/torch_sp_worker.py``), each rank given the rows
of its dp coordinate and keeping its sp block, for ``attn_impl`` "ring"
and "auto" (Ulysses at sp 2), on three test-size configs (2 layers,
d_model 128, 4 heads over 2 KV heads, f32): ``tiny``, ``tiny`` with a
window of 40 (the 32-row blocks meet a window-partial block, the ring's
offsets) and ``tiny-glm`` with a prefix per sequence (prefix-only
blocks). Batches from a numpy seed (B 4, S 64, a mask whose valid counts
differ by rank), initial weights from the JAX ``init_train_state``
carried over by ``models/convert.py``.

- After 2 steps, each rank's losses equal the one-process step's on the
  global batch within 1e-5 relative, and its parameters within 1e-4 of
  their scale (``test_torch_train_step.py``'s stream tolerances: the
  all-reduce and the ring's merge reorder f32 sums, which Adam's first
  updates amplify where v is small).
- The step-1 loss equals the JAX ``TrainStepBuilder(cfg,
  build_mesh(MeshConfig(dp=2, sp=4)), ..., attn_impl="ring")``'s to
  1e-4 relative, as JAX's ``test_ring_train_step_matches_dp`` holds
  its ring step to its dp step.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_sp_worker  # noqa: E402
from dlrover_tpu.models.config import get_config as jget  # noqa: E402
from dlrover_tpu.parallel import MeshConfig, build_mesh  # noqa: E402
from dlrover_tpu.train import optimizer as jopt  # noqa: E402
from dlrover_tpu.train import train_step as jts  # noqa: E402
from dlrover_tpu_torch.models import convert  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.train import optimizer as topt  # noqa: E402
from dlrover_tpu_torch.train import train_step as tts  # noqa: E402

_CFG = dict(n_layer=2, d_model=128, n_head=4, n_kv_head=2, d_ff=256,
            vocab_size=512, max_seq=64, tie_embeddings=False,
            dtype="float32")
_OPT = dict(learning_rate=1e-3, weight_decay=0.1, warmup_steps=2,
            decay_steps=20, grad_clip=1.0)
B, S = 4, 64
# name: (config, overrides, prefix_len per row)
_CONFIGS = {
    "tiny": ("tiny", {}, None),
    "window": ("tiny", dict(attn_window=40), None),
    "glm": ("tiny-glm", {}, (40, 0, 64, 10)),
}
_IMPLS = ("ring", "auto")


def _batches(name, n=2):
    prefix = _CONFIGS[name][2]
    rng = np.random.default_rng(sum(map(ord, name)))
    out = []
    for _ in range(n):
        tok = rng.integers(0, 512, size=(B, S + 1)).astype(np.int32)
        mask = np.ones((B, S), np.float32)
        mask[0, : S // 2] = 0.0   # rank (dp 0, sp 0) holds no valid token
        mask[3, -5:] = 0.0
        b = {"tokens": tok[:, :-1], "targets": tok[:, 1:], "mask": mask}
        if prefix is not None:
            b["prefix_len"] = np.asarray(prefix, np.int32)
        out.append(b)
    return out


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX init of each config, the port's 4-rank runs and the
    one-process runs."""
    jmesh = build_mesh(MeshConfig(dp=2, sp=4))
    configs, inits = {}, {}
    for name, (cname, over, _) in _CONFIGS.items():
        jcfg = jget(cname, **dict(_CFG, **over))
        jtx = jopt.make_optimizer(**_OPT)
        jstate = jts.init_train_state(jax.random.key(5), jcfg, jmesh, jtx)
        params = jax.tree.map(np.asarray, jstate["params"])
        cfg = get_config(cname, **dict(_CFG, **over))
        model = convert.load_jax_params(params, cfg, device="cpu",
                                        trainable=True)
        inits[name] = (jcfg, jtx, jstate, cfg)
        configs[name] = dict(
            name=cname, overrides=dict(_CFG, **over),
            state={k: v.detach().clone()
                   for k, v in model.state_dict().items()},
            batches=[_tb(b) for b in _batches(name)])
    ranks = torch_sp_worker.spawn(
        "train", {"configs": configs, "impls": _IMPLS, "opt": _OPT,
                  "mesh": {"dp": 2, "sp": 2}}, 4,
        tmp_path_factory.mktemp("sp_train"))
    single = {}
    for name, conf in configs.items():
        cfg = inits[name][3]
        tx = topt.make_optimizer(**_OPT)
        model = torch_sp_worker._model(cfg, conf["state"])
        state = {"params": model,
                 "opt_state": tx.init(dict(model.named_parameters())),
                 "step": 0}
        step = tts.TrainStepBuilder(cfg, tx, device="cpu").build()
        losses = [float(step(state, b)[1]["loss"]) for b in conf["batches"]]
        single[name] = (losses, {k: v.detach().clone()
                                 for k, v in model.state_dict().items()})
    return dict(jmesh=jmesh, inits=inits, ranks=ranks, single=single)


@pytest.mark.parametrize("impl", _IMPLS)
@pytest.mark.parametrize("name", list(_CONFIGS))
def test_mesh_steps_equal_the_one_process_step(setup, name, impl):
    losses, params = setup["single"][name]
    for rank in setup["ranks"]:
        got = rank[(name, impl)]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for k, ref in params.items():
            scale = max(float(ref.abs().max()), 1e-12)
            np.testing.assert_allclose(got["params"][k].numpy(),
                                       ref.numpy(), rtol=0,
                                       atol=1e-4 * scale, err_msg=k)


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_step_one_loss_equals_the_jax_ring_step(setup, name):
    jcfg, jtx, jstate, _ = setup["inits"][name]
    step = jts.TrainStepBuilder(jcfg, setup["jmesh"], jtx,
                                attn_impl="ring").build()
    batch = jax.tree.map(jnp.asarray, _batches(name)[0])
    _, jm = step(jstate, batch)
    for impl in _IMPLS:
        got = setup["ranks"][0][(name, impl)]["losses"][0]
        assert got == pytest.approx(float(jm["loss"]), rel=1e-4)
