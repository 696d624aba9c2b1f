"""The port's int8 KV block codec is bit-exact with the JAX codec.

Same rows (numpy, seeded) through ``dlrover_tpu.ops.quant`` and
``dlrover_tpu_torch.ops.quant``: payloads, scales (compared as raw f32
bits) and the decoded rows in bf16 and f32 must be identical — the
paged kernel's in-register dequant reproduces ``kv_decode_rows``, so
any drift here would show up as kernel error.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dlrover_tpu.ops import quant as jq  # noqa: E402
from dlrover_tpu_torch.ops import quant as tq  # noqa: E402


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 6, n)).astype(np.float32)
    x *= rng.uniform(1e-3, 50.0, (4, 6, 1)).astype(np.float32)
    x[0, 0] = 0.0           # all-zero row: the 1e-12 scale floor
    x[1, 1, ::3] = 0.5      # exact ties at the rounding boundary
    return x


@pytest.mark.parametrize("n", [128, 1024, 2048, 3 * 96])
def test_kv_block_size_matches(n):
    assert tq.kv_block_size(n) == jq.kv_block_size(n)


@pytest.mark.parametrize("n", [128, 1024, 2048])
def test_encode_decode_bit_exact(n):
    x = _rows(n, n)
    block = jq.kv_block_size(n)
    jqv, jsc = jq.kv_encode_rows(jnp.asarray(x), block)
    tqv, tsc = tq.kv_encode_rows(torch.from_numpy(x), block)
    np.testing.assert_array_equal(np.asarray(jqv), tqv.numpy())
    np.testing.assert_array_equal(
        np.asarray(jsc).view(np.uint32), tsc.numpy().view(np.uint32)
    )
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        jd = jq.kv_decode_rows(jqv, jsc, jdt).astype(jnp.float32)
        td = tq.kv_decode_rows(tqv, tsc, tdt).float()
        np.testing.assert_array_equal(
            np.asarray(jd).view(np.uint32), td.numpy().view(np.uint32)
        )


def test_block_spanning_heads_and_head_spanning_blocks():
    """llama3-8b's row (8 heads × 128) gets 256-wide blocks — one scale
    per two heads; a 3 × 96 row gets 144 — a head split over blocks."""
    assert tq.kv_block_size(8 * 128) == 256
    assert tq.kv_block_size(3 * 96) == 144
    with pytest.raises(ValueError):
        tq.kv_encode_rows(torch.zeros(2, 100), 64)
