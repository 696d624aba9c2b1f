"""The port's training slice against the JAX package's, end to end.

A tiny llama-shaped config (2 layers, d_model 128, 4 heads over 2 KV
heads, swiglu, rmsnorm, rope, untied head, f32) with params from the
JAX ``decoder.init``, carried into a trainable port ``Decoder`` by
``models/convert.py``. Checked on the CPU, where JAX runs its plain
attention and norms and the port its kernels' plain versions:

- ``loss_fn`` (fused and unfused CE, a mask, z_loss) and every gradient,
  brought back to the JAX tree by ``jax_tree_from_state_dict``;
- a 3-step loss stream of ``TrainStepBuilder`` against JAX's on a
  ``single_device_mesh``, with the same optimizer, and the params after;
- ``grad_accum=2`` the same way;
- remat "full" equal to "none", the fused norm path equal to the plain
  one, and the errors of what is not ported;
- the two head-packed families (D 64, MHA, so the auto ``head_pack``
  packs two heads a kernel block on the card): a gpt2-shaped config with
  an odd head count (5 heads of 64, layernorm with bias, gelu, learned
  positions, tied head) and a glm-shaped one (prefix-LM with
  ``prefix_len`` in the batch, rope, tied head), each with its loss,
  every gradient and a 3-step stream against JAX's.

Tolerances (f32; the point is the algorithm): loss 1e-5 relative; each
gradient leaf within 1e-4 of its own largest |value| (a sum of many
products through two layers, reassociated by two frameworks); the
3-step stream 1e-5 and its params 1e-4 of their scale (Adam divides by
sqrt(v), so a 1e-6 gradient difference can move an early update by more
where v is small).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.models import decoder as jdec  # noqa: E402
from dlrover_tpu.models.config import get_config as jget  # noqa: E402
from dlrover_tpu.parallel.mesh import single_device_mesh  # noqa: E402
from dlrover_tpu.train import optimizer as jopt  # noqa: E402
from dlrover_tpu.train import train_step as jts  # noqa: E402
from dlrover_tpu_torch.models import convert  # noqa: E402
from dlrover_tpu_torch.models import decoder as tdec  # noqa: E402
from dlrover_tpu_torch.models.config import get_config  # noqa: E402
from dlrover_tpu_torch.train import optimizer as topt  # noqa: E402
from dlrover_tpu_torch.train import train_step as tts  # noqa: E402

_CFG = dict(n_layer=2, d_model=128, n_head=4, n_kv_head=2, d_ff=256,
            vocab_size=512, max_seq=64, tie_embeddings=False,
            dtype="float32")
_OPT = dict(learning_rate=1e-3, weight_decay=0.1, warmup_steps=2,
            decay_steps=20, grad_clip=1.0)


def _configs(**kw):
    over = dict(_CFG, **kw)
    return jget("tiny", **over), get_config("tiny", **over)


def _batch(seed, b=4, s=32, vocab=512, mask=False):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, size=(b, s + 1)).astype(np.int32)
    out = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    if mask:
        m = np.ones((b, s), np.float32)
        m[0, : s // 2] = 0.0
        out["mask"] = m
    return out


def _jparams(jcfg, seed=0):
    return jax.tree.map(np.asarray, jdec.init(jax.random.key(seed), jcfg))


def _model(params, cfg):
    return convert.load_jax_params(params, cfg, device="cpu", trainable=True)


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _leaf_close(port, ref, tol=1e-4):
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("fused_ce,mask,z_loss", [
    (True, False, 0.0), (False, False, 0.0), (True, True, 1e-4),
    (False, True, 1e-4)])
def test_loss_and_every_gradient_match_jax(fused_ce, mask, z_loss):
    jcfg, cfg = _configs(fused_ce=fused_ce, ce_block_v=128)
    params = _jparams(jcfg)
    batch = _batch(1, mask=mask)
    mesh = single_device_mesh()

    def jloss(p):
        return jdec.loss_fn(p, jax.tree.map(jnp.asarray, batch), jcfg,
                            mesh=mesh, z_loss=z_loss)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    model = _model(params, cfg)
    loss, metrics = tdec.loss_fn(model, _tb(batch), z_loss=z_loss)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k in ("loss", "tokens", "accuracy"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-5, atol=1e-7)
    grads = {n: p.grad for n, p in model.named_parameters()}
    tree = convert.jax_tree_from_state_dict(grads, cfg)
    flat_t = jax.tree_util.tree_leaves_with_path(tree)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jg))
    assert len(flat_t) == len(flat_j)
    for path, leaf in flat_t:
        _leaf_close(leaf, np.asarray(flat_j[path]))


@pytest.mark.parametrize("fused", [False, True])
def test_three_step_loss_stream_matches_jax(fused):
    jcfg, cfg = _configs()
    mesh = single_device_mesh()
    jtx = jopt.make_optimizer(fused=fused, **_OPT)
    jstate = jts.init_train_state(jax.random.key(3), jcfg, mesh, jtx)
    params = jax.tree.map(np.asarray, jstate["params"])
    jstep = jts.TrainStepBuilder(jcfg, mesh, jtx).build()
    ttx = topt.make_optimizer(fused=fused, **_OPT)
    model = _model(params, cfg)
    state = {"params": model,
             "opt_state": ttx.init(dict(model.named_parameters())),
             "step": 0}
    step = tts.TrainStepBuilder(cfg, ttx, device="cpu").build()
    for i in range(3):
        batch = _batch(10 + i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, _tb(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert state["step"] == int(jstate["step"]) == 3
    sd = {n: p.detach() for n, p in model.named_parameters()}
    tree = convert.jax_tree_from_state_dict(sd, cfg)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jstate["params"])):
        _leaf_close(a, np.asarray(b))


def test_grad_accum_matches_jax():
    jcfg, cfg = _configs()
    mesh = single_device_mesh()
    jtx = jopt.make_optimizer(**_OPT)
    jstate = jts.init_train_state(jax.random.key(4), jcfg, mesh, jtx)
    params = jax.tree.map(np.asarray, jstate["params"])
    jstep = jts.TrainStepBuilder(jcfg, mesh, jtx, grad_accum=2).build()
    ttx = topt.make_optimizer(**_OPT)
    model = _model(params, cfg)
    state = {"params": model,
             "opt_state": ttx.init(dict(model.named_parameters())),
             "step": 0}
    step = tts.TrainStepBuilder(cfg, ttx, grad_accum=2, device="cpu").build()
    for i in range(2):
        batch = _batch(20 + i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, _tb(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    tree = convert.jax_tree_from_state_dict(
        {n: p.detach() for n, p in model.named_parameters()}, cfg)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jstate["params"])):
        _leaf_close(a, np.asarray(b))


def _loss_and_grads(model, batch, cfg):
    model.zero_grad(set_to_none=True)
    loss, _ = tdec.loss_fn(model, batch, cfg)
    loss.backward()
    return loss.detach(), [p.grad.clone() for p in model.parameters()]


def test_full_remat_equals_none():
    jcfg, cfg = _configs()
    model = _model(_jparams(jcfg, 5), cfg)
    batch = _tb(_batch(5))
    l0, g0 = _loss_and_grads(model, batch, cfg)
    l1, g1 = _loss_and_grads(model, batch,
                             dataclasses.replace(cfg, remat="full"))
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_fused_norm_path_equals_the_plain_norm():
    """``fused_norm=True`` on the CPU runs ``ops.norm`` (the kernels'
    plain versions and the kernel backward's formulas); None runs the
    decoder's plain ``_norm`` through autograd. Same numbers to 1e-5."""
    jcfg, cfg = _configs()
    model = _model(_jparams(jcfg, 6), cfg)
    batch = _tb(_batch(6))
    l0, g0 = _loss_and_grads(model, batch, cfg)
    l1, g1 = _loss_and_grads(model, batch,
                             dataclasses.replace(cfg, fused_norm=True))
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for a, b in zip(g1, g0):
        _leaf_close(a.numpy(), b.numpy(), 1e-5)


def test_reference_attention_matches_flash_path():
    jcfg, cfg = _configs()
    model = _model(_jparams(jcfg, 7), cfg)
    batch = _tb(_batch(7))
    a = tdec.forward(model, batch["tokens"], attn_impl="reference")
    b = tdec.forward(model, batch["tokens"], attn_impl="auto")
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_trainable_and_serving_decoders_hold_their_dtypes():
    _, cfg = _configs(dtype="bfloat16")
    train = tdec.Decoder(cfg, device="cpu", trainable=True)
    serve = tdec.Decoder(cfg, device="cpu")
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in train.parameters())
    assert all(not p.requires_grad for p in serve.parameters())
    assert serve.layers[0].attn.wq.weight.dtype == torch.bfloat16
    assert serve.layers[0].ln1.scale.dtype == torch.float32


def test_init_train_state_and_loss_falls():
    _, cfg = _configs()
    tx = topt.make_optimizer(learning_rate=3e-3, warmup_steps=1,
                             decay_steps=50)
    state = tts.init_train_state(0, cfg, tx, device="cpu")
    step = tts.TrainStepBuilder(cfg, tx, device="cpu").build()
    batch = _tb(_batch(8))
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(5)]
    assert losses[-1] < losses[0]
    assert state["step"] == 5


def test_unported_options_raise():
    _, cfg = _configs(remat="save_qkv")
    model = tdec.init(cfg, seed=0, device="cpu", trainable=True)
    batch = _tb(_batch(9))
    with pytest.raises(NotImplementedError, match="A21"):
        tdec.loss_fn(model, batch)
    with pytest.raises(ValueError, match="needs a mesh"):
        tdec.loss_fn(model, batch, dataclasses.replace(cfg, remat="none"),
                     attn_impl="ring")
    with pytest.raises(NotImplementedError, match="A16"):
        tdec.init(dataclasses.replace(cfg, remat="none", n_experts=4),
                  seed=0, device="cpu", trainable=True)
    with pytest.raises(ValueError, match="grad_accum"):
        tts.TrainStepBuilder(cfg, topt.make_optimizer(), grad_accum=0,
                             device="cpu")


@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_local_attention_under_an_sp_mesh_raises(impl):
    """Under sp > 1 each rank holds one sequence block: "flash" and
    "reference" would attend within it alone, so they refuse the mesh."""
    from dlrover_tpu_torch.parallel.mesh import Mesh

    _, cfg = _configs()
    model = tdec.init(cfg, seed=0, device="cpu", trainable=True)
    batch = _tb(_batch(9))
    mesh = Mesh({"dp": 1, "sp": 4}, rank=1)
    with pytest.raises(ValueError, match="needs \"ring\", \"ulysses\""):
        tdec.loss_fn(model, batch, cfg, attn_impl=impl, mesh=mesh)
    # sp == 1 is no sequence split: the local attention is the whole one
    tdec.loss_fn(model, batch, cfg, attn_impl=impl,
                 mesh=Mesh({"dp": 1, "sp": 1}))


def test_state_dict_round_trip_through_the_jax_tree():
    jcfg, cfg = _configs(norm="layernorm", act="gelu", pos="learned",
                         tie_embeddings=True)
    params = _jparams(jcfg, 9)
    model = _model(params, cfg)
    tree = convert.jax_tree_from_state_dict(model.state_dict(), cfg)
    assert jax.tree.structure(tree) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


# the head-packed families at D 64 (MHA): gpt2-shaped with an odd head
# count, glm-shaped with a prefix-LM mask
_PACKED = {
    "gpt2": dict(n_layer=2, d_model=320, n_head=5, n_kv_head=None, d_ff=640,
                 norm="layernorm", act="gelu", pos="learned",
                 tie_embeddings=True),
    "glm": dict(n_layer=2, d_model=128, n_head=2, n_kv_head=None, d_ff=512,
                norm="layernorm", act="gelu", pos="rope", prefix_lm=True,
                tie_embeddings=True),
}


def _packed_batch(kind, seed):
    batch = _batch(seed)
    if kind == "glm":
        # a bidirectional prefix per sequence (one empty, one whole), the
        # loss on the tail only, as examples/train_glm.py trains it
        pref = np.array([5, 0, 17, 32], np.int32)
        batch["prefix_len"] = pref
        batch["mask"] = (np.arange(32)[None] >= pref[:, None]).astype(
            np.float32)
    return batch


@pytest.mark.parametrize("kind", sorted(_PACKED))
def test_packed_families_loss_and_every_gradient_match_jax(kind):
    jcfg, cfg = _configs(**_PACKED[kind])
    assert cfg.head_dim == 64 and cfg.kv_heads == cfg.n_head
    params = _jparams(jcfg, 11)
    batch = _packed_batch(kind, 12)
    mesh = single_device_mesh()

    def jloss(p):
        return jdec.loss_fn(p, jax.tree.map(jnp.asarray, batch), jcfg,
                            mesh=mesh)

    (jl, _), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    model = _model(params, cfg)
    loss, _ = tdec.loss_fn(model, _tb(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    tree = convert.jax_tree_from_state_dict(grads, cfg)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jg))
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        _leaf_close(leaf, np.asarray(flat_j[path]))


@pytest.mark.parametrize("kind", sorted(_PACKED))
def test_packed_families_three_step_stream_matches_jax(kind):
    jcfg, cfg = _configs(**_PACKED[kind])
    mesh = single_device_mesh()
    jtx = jopt.make_optimizer(**_OPT)
    jstate = jts.init_train_state(jax.random.key(13), jcfg, mesh, jtx)
    jstep = jts.TrainStepBuilder(jcfg, mesh, jtx).build()
    ttx = topt.make_optimizer(**_OPT)
    model = _model(jax.tree.map(np.asarray, jstate["params"]), cfg)
    state = {"params": model,
             "opt_state": ttx.init(dict(model.named_parameters())),
             "step": 0}
    step = tts.TrainStepBuilder(cfg, ttx, device="cpu").build()
    for i in range(3):
        batch = _packed_batch(kind, 30 + i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, _tb(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    tree = convert.jax_tree_from_state_dict(
        {n: p.detach() for n, p in model.named_parameters()}, cfg)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jstate["params"])):
        _leaf_close(a, np.asarray(b))
