"""The port's sequence parallelism against the JAX package's, on the CPU.

``ring_attention`` and ``ulysses_attention`` of ``dlrover_tpu_torch.
parallel.sequence`` run in 4 processes (a gloo group, ``MeshConfig(sp=4)``,
each rank with its 256-row sequence block; ``tests/torch_sp_worker.py``),
the JAX functions on the 8-device CPU mesh ``MeshConfig(dp=2, sp=4)``
(``tests/conftest.py``) with the same global inputs from a numpy seed:
B 2, S 1024, H 4, D 32, f32. The outputs and the q/k/v gradients of
``sum(out · cotangent)`` are compared, the port's blocks joined in sp
order.

Cases: causal, non-causal, a window of 400 over the 256-wide blocks
(dense, diagonal, window-partial and empty blocks all run), a prefix per
sequence (300 and 700: prefix-only blocks), and GQA (2 KV heads, kept at
2 on the ring). The port's ring runs every block through
``flash_attention_with_lse`` (the kernels' plain versions on the CPU),
the offsets on its window-partial and prefix-only blocks; the JAX ring
on the CPU runs its jnp blocks. Ulysses: the window, the prefix and GQA
(causal), both sides with ``mha_reference`` inside.

Tolerances, f32: the outputs 2e-5, as JAX's
``test_ring_attention_matches_reference``; the gradients 1e-4 (JAX's
``test_ring_attention_grads`` allows 5e-4): the same sums in another
order, through the merge's logaddexp.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_sp_worker  # noqa: E402
from dlrover_tpu.parallel import MeshConfig, build_mesh  # noqa: E402
from dlrover_tpu.parallel.sequence import (  # noqa: E402
    ring_attention as jring,
    ulysses_attention as julysses,
)

B, S, H, D, SP = 2, 1024, 4, 32, 4
PREFIX = (300, 700)
# name: (causal, KV heads, window, prefix, impls)
_CASES = {
    "causal": (True, H, 0, None, ("ring",)),
    "non_causal": (False, H, 0, None, ("ring",)),
    "window": (True, H, 400, None, ("ring", "ulysses")),
    "prefix": (True, H, 0, PREFIX, ("ring", "ulysses")),
    "gqa": (True, 2, 0, None, ("ring", "ulysses")),
}
_PAIRS = [(n, i) for n, c in _CASES.items() for i in c[4]]


def _inputs(name):
    causal, hkv, window, prefix, impls = _CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    return dict(
        q=rng.standard_normal((B, S, H, D), dtype=np.float32),
        k=rng.standard_normal((B, S, hkv, D), dtype=np.float32),
        v=rng.standard_normal((B, S, hkv, D), dtype=np.float32),
        ct=rng.standard_normal((B, S, H, D), dtype=np.float32),
        causal=causal, window=window, prefix=prefix, impls=impls)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case through the port's 4 ranks: {(case, impl): [out, dq,
    dk, dv]}, each joined over the ranks' sequence blocks."""
    cases = {}
    for name in _CASES:
        c = _inputs(name)
        cases[name] = dict(
            {k: torch.from_numpy(c[k]) for k in ("q", "k", "v", "ct")},
            causal=c["causal"], window=c["window"], impls=c["impls"],
            prefix=None if c["prefix"] is None
            else torch.tensor(c["prefix"], dtype=torch.int32))
    ranks = torch_sp_worker.spawn(
        "attention", {"cases": cases, "mesh": {"dp": 1, "sp": SP}}, SP,
        tmp_path_factory.mktemp("sequence"))
    return {key: [torch.cat([r[key][i] for r in ranks], 1).numpy()
                  for i in range(4)] for key in ranks[0]}


@pytest.fixture(scope="module")
def mesh():
    return build_mesh(MeshConfig(dp=2, sp=SP))


@pytest.mark.parametrize("name,impl", _PAIRS)
def test_port_matches_jax(port, mesh, name, impl):
    c = _inputs(name)
    kw = dict(causal=c["causal"], window=c["window"])
    if c["prefix"] is not None:
        kw["prefix_len"] = jnp.asarray(c["prefix"], jnp.int32)
    fn = jring if impl == "ring" else julysses

    @jax.jit
    def f(q, k, v, ct):
        out, vjp = jax.vjp(lambda *a: fn(*a, mesh, **kw), q, k, v)
        return out, vjp(ct)

    # under jit: op by op, the shard_maps take ~10 s a case to dispatch
    out, grads = f(*(jnp.asarray(c[k]) for k in ("q", "k", "v", "ct")))
    got = port[(name, impl)]
    np.testing.assert_allclose(got[0], np.asarray(out), rtol=2e-5,
                               atol=2e-5)
    for g, ref in zip(got[1:], grads):
        np.testing.assert_allclose(g, np.asarray(ref), rtol=1e-4, atol=1e-4)
