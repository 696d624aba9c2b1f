"""The port's sampler: the warp matches JAX, the draw is position-keyed.

``warp_logits`` runs on the same seeded logits in both packages (JAX
row by row, the port batched): the masks must be identical and the
kept values equal to f32 rounding (rtol 1e-6). The draw cannot match
JAX's threefry bits, so it is held to its own contract: greedy is
argmax; a sampled token depends only on (seed, position), not on the
slot or the rest of the batch; top-k/top-p masks are honoured; and the
Gumbel-max draw follows softmax(logits / T) (frequencies within 0.015
of the probabilities over 20,000 positions — about 5 standard errors).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.models import generate as jgen  # noqa: E402
from dlrover_tpu_torch.models import generate as tgen  # noqa: E402

_PARAMS = [  # (temperature, top_k, top_p) per row
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.9), (0.5, 3, 0.8),
    (2.0, 1, 1.0), (0.9, 0, 0.05), (1.1, 40, 0.95),
]


def test_warp_logits_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((len(_PARAMS), 40)) * 3).astype(np.float32)
    t, k, p = (np.asarray(x) for x in zip(*_PARAMS))
    ours = tgen.warp_logits(torch.from_numpy(logits),
                            torch.tensor(t, dtype=torch.float32),
                            torch.tensor(k), torch.tensor(p,
                                                          dtype=torch.float32))
    for i, (ti, ki, pi) in enumerate(_PARAMS):
        ref = np.asarray(jgen.warp_logits(jnp.asarray(logits[i]), ti, ki, pi))
        mine = ours[i].numpy()
        np.testing.assert_array_equal(np.isinf(mine), np.isinf(ref))
        keep = ~np.isinf(ref)
        np.testing.assert_allclose(mine[keep], ref[keep], rtol=1e-6)


def test_greedy_is_argmax_and_mixes_with_sampled_rows():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((4, 30)).astype(np.float32))
    temp = torch.tensor([0.0, 1.0, 0.0, 0.8])
    tok = tgen.draw_token(logits, torch.arange(4), torch.full((4,), 9), temp)
    assert tok.dtype == torch.int32
    am = logits.argmax(-1)
    assert tok[0] == am[0] and tok[2] == am[2]
    all_greedy = tgen.draw_token(logits, torch.arange(4), torch.zeros(4),
                                 torch.zeros(4))
    assert torch.equal(all_greedy.long(), am)


def test_draw_depends_only_on_seed_and_position():
    """A request alone, or in slot 3 of a full batch of other requests,
    draws the same token at the same absolute position."""
    rng = np.random.default_rng(2)
    v = 50
    row = rng.standard_normal(v).astype(np.float32)
    batch = rng.standard_normal((8, v)).astype(np.float32)
    batch[3] = row
    for pos in (0, 17, 2047, 123456):
        alone = tgen.draw_token(
            torch.from_numpy(row[None]), torch.tensor([77]),
            torch.tensor([pos]), torch.tensor([0.8]), 0, torch.tensor([0.9]))
        seeds = torch.tensor([5, 6, 7, 77, 8, 9, 10, 11])
        full = tgen.draw_token(
            torch.from_numpy(batch), seeds, torch.full((8,), pos),
            torch.full((8,), 0.8), 0, torch.full((8,), 0.9))
        assert int(alone[0]) == int(full[3])
    # and the noise really is keyed: other seeds/positions differ
    g = tgen.gumbel_noise(torch.tensor([1, 1, 2]), torch.tensor([4, 5, 4]), v)
    assert not torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])
    assert torch.equal(g[0], tgen.gumbel_noise(torch.tensor([1]),
                                               torch.tensor([4]), v)[0])


def test_top_k_and_top_p_masks_are_honoured():
    logits = torch.tensor([[3.0, 2.0, 1.0, 0.0, -1.0]]).expand(500, 5)
    pos = torch.arange(500)
    k2 = tgen.draw_token(logits, torch.zeros(500), pos, torch.ones(500), 2)
    assert set(k2.tolist()) == {0, 1}
    p = tgen.draw_token(logits, torch.zeros(500), pos, torch.ones(500), 0,
                        torch.full((500,), 0.5))
    assert set(p.tolist()) == {0}  # the top token alone holds 66% > 0.5


def test_gumbel_max_follows_the_softmax():
    logits = torch.tensor([[1.0, 0.2, -0.5, 0.7]])
    n = 20000
    tok = tgen.draw_token(logits.expand(n, 4), torch.full((n,), 12345),
                          torch.arange(n), torch.full((n,), 1.5))
    freq = torch.bincount(tok.long(), minlength=4).double() / n
    prob = torch.softmax(logits[0].double() / 1.5, -1)
    assert float((freq - prob).abs().max()) < 0.015
