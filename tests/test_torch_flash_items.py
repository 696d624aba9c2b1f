"""The work items of the persistent bf16 flash forwards, on the CPU.

``flash_fwd_wgmma_kernel`` (K1, one head of 128 q rows an item) and
``flash_fwd_packed_wgmma_kernel`` (K1p, two heads of 64 and 64 q rows)
are one persistent body in ``csrc/flash_attention.cu``: one block an SM
takes items from its kernel's counter in device memory and maps each
item number to (batch element, head, q tile) by ``fwd_item``. Its plain
twin is ``ops.flash_attention.fwd_items``. Here, exactly (integers):

- the items cover every (batch element, head, q tile) once, and the
  count is the one the launcher sizes the grid by;
- each head's q tiles come from the last (under causal the items that do
  the most work first);
- K1 keeps the query heads of one KV group side by side at each q tile;
- ``fwd_items`` equals a line-by-line transliteration of the C
  arithmetic of ``fwd_item`` (divisions and remainders of the item
  number);
- the source gives K1 a counter of its own (not K1p's), and the bf16
  path has no per-element mask rule left (``FlashMask``).

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import pytest

from dlrover_tpu_torch.ops import flash_attention as fa

_SRC = (Path(fa.__file__).resolve().parent.parent / "csrc"
        / "flash_attention.cu").read_text()

_SHAPES = [
    # (b, sq, h, hkv): llama-1.4b, GQA groups of 2 / 4 / 8, ragged Sq,
    # one q tile, gpt2-1.5b's odd head count
    (8, 1024, 16, 16), (2, 1000, 8, 4), (3, 257, 16, 4), (1, 300, 8, 1),
    (2, 128, 4, 2), (1, 64, 2, 2), (8, 1024, 25, 25), (2, 1001, 12, 12)]


# the packed kernel takes MHA only
_CASES = [shape + (pack,) for shape in _SHAPES for pack in (1, 2)
          if pack == 1 or shape[2] == shape[3]]


def _c_fwd_item(w, b, sq, h, hkv, pack):
    """``fwd_item<NH>`` of ``csrc/flash_attention.cu``, line by line:
    (batch element, first head, first q row) of item ``w``."""
    rows = 128 // pack
    n_qt = (sq + rows - 1) // rows
    if pack == 1:
        groups = h // hkv
        r = w // groups
        bk = r // n_qt
        q0 = (n_qt - 1 - r % n_qt) * rows
        return bk // hkv, (bk % hkv) * groups + w % groups, q0
    packs = (h + 1) // 2
    bp = w // n_qt
    return bp // packs, (bp % packs) * 2, (n_qt - 1 - w % n_qt) * rows


def _n_items(b, sq, h, pack):
    """``fwd_items`` of the C side: what the launcher sizes the grid by."""
    rows = 128 // pack
    return (sq + rows - 1) // rows * b * ((h + pack - 1) // pack)


@pytest.mark.parametrize("b,sq,h,hkv,pack", _CASES)
def test_items_cover_every_tile_once(b, sq, h, hkv, pack):
    items = fa.fwd_items(b, sq, h, hkv, pack)
    rows = 128 // pack
    want = {(bi, hh, q0) for bi in range(b) for hh in range(0, h, pack)
            for q0 in range(0, sq, rows)}
    assert len(items) == len(want) == _n_items(b, sq, h, pack)
    assert set(items) == want


@pytest.mark.parametrize("b,sq,h,hkv,pack", _CASES)
def test_items_match_the_kernels_arithmetic(b, sq, h, hkv, pack):
    items = fa.fwd_items(b, sq, h, hkv, pack)
    assert items == [_c_fwd_item(w, b, sq, h, hkv, pack)
                     for w in range(_n_items(b, sq, h, pack))]


@pytest.mark.parametrize("b,sq,h,hkv", _SHAPES)
def test_q_tiles_come_from_the_last(b, sq, h, hkv):
    """Under causal the last q tile sees the most keys: each head's tiles
    run from the last to the first, one after the other in item order."""
    seen = {}
    for bi, hh, q0 in fa.fwd_items(b, sq, h, hkv, 1):
        seen.setdefault((bi, hh), []).append(q0)
    for tiles in seen.values():
        assert tiles == sorted(tiles, reverse=True)


@pytest.mark.parametrize("b,sq,h,hkv", _SHAPES)
def test_gqa_groups_are_adjacent(b, sq, h, hkv):
    """K1 gives the query heads of one KV group adjacent items at each q
    tile, so their K/V tiles are read by blocks at work at the same
    time (and stay in L2)."""
    groups = h // hkv
    items = fa.fwd_items(b, sq, h, hkv, 1)
    for start in range(0, len(items), groups):
        run = items[start:start + groups]
        assert len({(bi, q0) for bi, _, q0 in run}) == 1
        heads = [hh for _, hh, _ in run]
        assert heads == list(range(heads[0], heads[0] + groups))
        assert heads[0] % groups == 0  # one KV head's whole group


def test_k1_takes_its_own_counter():
    """K1 and K1p are one body; K1's items come from ``g_fwd_work``, K1p's
    from ``g_packed_work``, and each kernel instantiates the body with
    its heads an item."""
    body = re.search(r"unsigned int\* fwd_work\(\) \{(.*?)\}", _SRC,
                     re.S).group(1)
    assert "NH == 1 ? g_fwd_work : g_packed_work" in body
    assert re.search(r"__device__ unsigned int g_fwd_work\[2\];", _SRC)
    assert re.search(r"__device__ unsigned int g_packed_work\[2\];", _SRC)
    k1 = re.search(r"flash_fwd_wgmma_kernel\(.*?\{(.*?)\n\}", _SRC,
                   re.S).group(1)
    k1p = re.search(r"flash_fwd_packed_wgmma_kernel\(.*?\{(.*?)\n\}", _SRC,
                    re.S).group(1)
    assert "fwd_wgmma_body<D, 1>" in k1
    assert "fwd_wgmma_body<kPackD, 2>" in k1p


def test_the_bf16_forward_masks_by_key_ranges():
    """The per-element mask rule with branches is gone from the bf16
    path: the forward body masks by ``RangeMask``, a key range a row."""
    assert "FlashMask" not in _SRC
    body = re.search(r"void fwd_wgmma_body\(.*?\n\}", _SRC, re.S).group(0)
    assert "RangeMask pol;" in body
    assert "load_q" not in body  # Q comes by TMA
    assert "tma_load_4d(q_tile(" in body
