"""The bridge between the JAX train state and the port's.

The JAX decoder's params (``dlrover_tpu.models.decoder.init``'s nested
dict) stack per-layer tensors on axis 0 and keep matrices as
``[in, out]``; the port's ``Decoder`` keeps one ``nn.Linear`` a layer,
``[out, in]``, and ties the head to the embedding where the config
says so. ``param_table`` is that correspondence, leaf by leaf, and
everything here reads it:

- ``state_dict_from_jax`` / ``jax_tree_from_state_dict`` / ``load_jax_params``:
  a param tree of numpy arrays ⇄ a ``Decoder`` state dict (or a dict of
  its gradients under the same names); given a sharded mesh, the state
  dict of that rank's shards (``decoder.param_layout``), and
  ``gather_jax_tree`` assembles the whole tree from every rank's;
- ``train_state_leaves``: a port train state (``train_step.init_train_state``)
  as the flattened leaves of the JAX train state, ``params/...``, the
  AdamW moments and counts under the optax state's paths for the same
  optimizer settings, and ``step``. A stacked leaf's L shards are the
  port's L per-layer tensors (transposed where the port keeps
  ``[out, in]``); a sharded model's shards carry their global indices.
  The checkpoint pack writes and restores these leaves, so a pack
  restores in either package and at any other layout;
- ``train_state_arrays`` / ``load_train_state_arrays``: the same leaves
  as ``{path: numpy array}`` (bf16 as ``np.uint16`` words: no ml_dtypes),
  the flattened JAX train state of numpy arrays.

Under ZeRO update sharding (``shard=(plan, dp rank)``) the moments are
the JAX update-sharded state's flat leaves, ``<mu path>/flat`` and
``<nu path>/flat`` of global shape ``(n_buckets, bucket_elems)``, of
which a rank holds (and packs) its dp columns: the pack's shard index
says which, so a pack per dp rank holds the whole state between them. On
a dp × fsdp × tp mesh (the hybrid ZeRO step) the flat stream is the
global leaves', every fsdp × tp peer of a dp rank packs the same
columns, and the parameters are each rank's shards. A restore given
``moment_bridge`` reads the flat moments into per-leaf ones and back,
at the plan's offsets, so such a pack restores in one process, at
another mesh without ZeRO, or at a pure-dp ZeRO layout of the same
plan.

It reads and writes numpy only: the caller moves arrays out of and into
JAX.
"""

import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.checkpoint import core
from dlrover_tpu_torch.models.config import ModelConfig
from dlrover_tpu_torch.models.decoder import (  # noqa: F401 (re-exported)
    Decoder,
    ParamRow,
    param_layout,
    param_table,
)
from dlrover_tpu_torch.parallel.mesh import Mesh


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _set(tree, path, value):
    *head, last = path.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def state_dict_from_jax(params: Dict[str, Any], cfg: ModelConfig,
                        mesh=None):
    """The ``Decoder`` state dict (f32 CPU tensors) for a JAX param tree
    of numpy arrays: under a sharded ``mesh`` (a ``parallel.mesh.Mesh``:
    its shape and this rank), each tensor this rank's shard."""
    layout = param_layout(cfg, mesh if mesh is not None and mesh.sharded
                          else None)

    def t(a, name):
        shard = layout[name]
        a = np.asarray(a, np.float32)[tuple(slice(*i) for i in shard.index)]
        return torch.from_numpy(np.array(a.T if shard.transposed else a,
                                         order="C"))

    sd = {}
    for path, name, stacked, _ in param_table(cfg):
        a = _get(params, path)
        if stacked:
            for i in range(cfg.n_layer):
                sd[name.format(i)] = t(a[i], name.format(i))
        else:
            sd[name] = t(a, name)
    return sd


def gather_jax_tree(state_dicts: List[Dict[str, torch.Tensor]],
                    cfg: ModelConfig, sizes: Dict[str, int]
                    ) -> Dict[str, Any]:
    """The JAX param tree (numpy f32) assembled from every rank's sharded
    state dict (or gradients, or AdamW moments, under the parameter
    names), ``state_dicts[r]`` rank r's of a mesh of ``sizes``."""
    tree: Dict[str, Any] = {}
    for rank, sd in enumerate(state_dicts):
        layout = param_layout(cfg, Mesh(sizes, rank))
        for path, name, stacked, _ in param_table(cfg):
            for i in range(cfg.n_layer) if stacked else (None,):
                key = name.format(i) if stacked else name
                shard = layout[key]
                try:
                    full = _get(tree, path)
                except KeyError:
                    full = np.zeros(((cfg.n_layer,) if stacked else ())
                                    + shard.shape, np.float32)
                    _set(tree, path, full)
                x = sd[key].detach().float().cpu().numpy()
                idx = tuple(slice(*i) for i in shard.index)
                (full[i] if stacked else full)[idx] = (
                    x.T if shard.transposed else x)
    return tree


def jax_tree_from_state_dict(sd: Dict[str, torch.Tensor],
                             cfg: ModelConfig) -> Dict[str, Any]:
    """The JAX param tree (numpy f32 leaves, layers stacked on axis 0,
    matrices ``[in, out]``) of a ``Decoder`` state dict, or of a dict of
    its gradients under the same names."""
    def a(name, transpose):
        x = sd[name].detach().float().cpu().numpy()
        return np.ascontiguousarray(x.T if transpose else x)

    tree: Dict[str, Any] = {}
    for path, name, stacked, transposed in param_table(cfg):
        if stacked:
            _set(tree, path, np.stack([a(name.format(i), transposed)
                                       for i in range(cfg.n_layer)]))
        else:
            _set(tree, path, a(name, transposed))
    return tree


@torch.no_grad()
def load_jax_params(params: Dict[str, Any], cfg: ModelConfig, *,
                    device="cuda", trainable: bool = False,
                    mesh=None) -> Decoder:
    """A ``Decoder`` on ``device`` holding the JAX params' values: frozen
    matrices rounded to ``cfg.dtype`` (serving), or with ``trainable``
    every parameter trainable in ``cfg.param_dtype``; norms f32. Under a
    sharded ``mesh``, this rank's shards of them."""
    model = Decoder(cfg, device=device, trainable=trainable, mesh=mesh)
    model.load_state_dict(state_dict_from_jax(params, cfg, mesh),
                          strict=True)
    return model


# ---- the whole train state ---------------------------------------------


def opt_state_paths(optimizer) -> Tuple[List[str], str, str]:
    """The JAX paths of the AdamW counts, first and second moments for
    the port ``AdamW``'s settings: the optax state of
    ``make_optimizer(...)`` with the same ``fused``, ``grad_clip`` and
    schedule. ``fused_adamw`` keeps ``{"m", "step", "v"}``; the chain
    ``(clip_by_global_norm?, adamw)`` keeps ``ScaleByAdamState(count,
    mu, nu)`` in its last link, and a ``ScaleByScheduleState(count)``
    there when the learning rate is a schedule."""
    if optimizer.fused:
        return ["opt_state/step"], "opt_state/m", "opt_state/v"
    link = "opt_state/1" if optimizer.grad_clip and optimizer.grad_clip > 0 \
        else "opt_state/0"
    counts = [f"{link}/0/count"]
    if callable(optimizer.learning_rate):
        counts.append(f"{link}/2/count")
    return counts, f"{link}/0/mu", f"{link}/0/nu"


def _tensor_leaves(prefix: str, tensors: Dict[str, torch.Tensor],
                   cfg: ModelConfig, layout) -> List[core.Leaf]:
    leaves = []
    for path, name, stacked, transposed in param_table(cfg):
        names = ([name.format(i) for i in range(cfg.n_layer)] if stacked
                 else [name])
        shard = layout[names[0]]
        index = [list(i) for i in shard.index]
        gshape = list(shard.shape)
        if stacked:
            gshape = [cfg.n_layer] + gshape
            shards = [core.Shard([[i, i + 1]] + index,
                                 tensors[n].detach(), transposed)
                      for i, n in enumerate(names)]
        else:
            shards = [core.Shard(index, tensors[name].detach(), transposed)]
        leaves.append(core.Leaf(f"{prefix}/{path}",
                                core.dtype_name(tensors[names[0]].dtype),
                                gshape, shards))
    return leaves


def _scalar_leaf(path: str, value: int) -> core.Leaf:
    return core.Leaf(path, "int32", [],
                     [core.Shard([], torch.tensor(value, dtype=torch.int32))])


def _flat_leaf(path: str, t: torch.Tensor, shard) -> core.Leaf:
    """This rank's columns ``t`` of a flat ``(n_buckets, bucket_elems)``
    leaf."""
    plan, rank = shard
    cols = plan.columns(rank)
    return core.Leaf(f"{path}/flat", core.dtype_name(t.dtype),
                     [plan.n_buckets, plan.bucket_elems],
                     [core.Shard([[0, plan.n_buckets], [cols.start, cols.stop]],
                                 t.detach())])


def train_state_leaves(state: Dict, cfg: ModelConfig, optimizer,
                       shard=None) -> List[core.Leaf]:
    """The port train state as the JAX train state's flattened leaves, in
    JAX's order (dict keys sorted). The tensors are the state's own
    (detached views): a restore into these leaves writes the state; the
    scalars (``step``, the counts) are copies that ``load_scalars`` puts
    back. ``shard``: ``(PackPlan, rank)`` of an update-sharded state
    (``TrainStepBuilder.shard``), whose moments are flat columns. A
    sharded model's parameters and moments are its shards, each with its
    global index (``Decoder.layout``)."""
    opt = state["opt_state"]
    params = dict(state["params"].named_parameters())
    layout = state["params"].layout
    counts, mu, nu = opt_state_paths(optimizer)
    if shard is not None:
        moments = [_flat_leaf(mu, opt["m"]["flat"], shard),
                   _flat_leaf(nu, opt["v"]["flat"], shard)]
    else:
        moments = (_tensor_leaves(mu, opt["m"], cfg, layout)
                   + _tensor_leaves(nu, opt["v"], cfg, layout))
    leaves = (_tensor_leaves("params", params, cfg, layout) + moments
              + [_scalar_leaf(c, opt["step"]) for c in counts]
              + [_scalar_leaf("step", state["step"])])
    return sorted(leaves, key=lambda leaf: leaf.path.split("/"))


def moment_bridge(cfg: ModelConfig, optimizer
                  ) -> Callable[[Sequence[core.Leaf], core.PackIndex], None]:
    """``core.restore_leaves``'s bridge for a train state of ``cfg`` and
    ``optimizer``: each AdamW moment the leaves ask for in the layout the
    pack lacks is added from the one it holds. A ``<moment>/flat`` leaf
    (ZeRO's stream, global ``(n_buckets, bucket_elems)``) is laid out
    from the per-leaf moments; per-leaf moments are cut from the flat
    one. Where each leaf lies in the stream is the ``PackPlan``'s
    (``sharding.build_pack_plan``: its offsets do not depend on dp or the
    bucket size; zeros after the last leaf)."""
    from dlrover_tpu_torch.parallel.sharding import build_pack_plan, pack_rows

    plan = build_pack_plan(cfg, {}, 1)
    _, mu, nu = opt_state_paths(optimizer)

    def bridge(leaves: Sequence[core.Leaf], idx: core.PackIndex) -> None:
        want = {leaf.path: leaf for leaf in leaves}
        for prefix in (mu, nu):
            flat = f"{prefix}/flat"
            parts = [(f"{prefix}/{row[0]}", off, size, shape)
                     for row, off, size, shape in zip(
                         pack_rows(cfg), plan.offsets, plan.sizes,
                         plan.shapes)]
            if (flat in want and flat not in idx
                    and all(p in idx for p, *_ in parts)):
                shape = list(want[flat].global_shape)
                stream = torch.zeros(math.prod(shape),
                                     dtype=idx.dtype(parts[0][0]))
                for p, off, size, leaf_shape in parts:
                    stream[off: off + size] = idx.read_slice(
                        p, [[0, d] for d in leaf_shape]).reshape(-1)
                idx.add_tensor(flat, stream.view(shape))
            missing = [x for x in parts if x[0] in want and x[0] not in idx]
            if missing and flat in idx:
                stream = idx.read_slice(
                    flat, [[0, d] for d in idx.global_shape(flat)]
                ).reshape(-1)
                for p, off, size, leaf_shape in missing:
                    idx.add_tensor(p, stream[off: off + size].reshape(
                        leaf_shape))

    return bridge


def load_scalars(state: Dict, leaves: List[core.Leaf], optimizer) -> None:
    """Put the restored ``step`` and AdamW count of ``leaves`` (from
    ``train_state_leaves``) back into ``state``."""
    by_path = {leaf.path: leaf for leaf in leaves}
    state["step"] = int(by_path["step"].shards[0].tensor)
    count = opt_state_paths(optimizer)[0][0]
    state["opt_state"]["step"] = int(by_path[count].shards[0].tensor)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.require(a, requirements=("C", "W"))  # a 0-dim array stays 0-dim
    if a.dtype == np.uint16:  # bf16 words
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def train_state_arrays(state: Dict, cfg: ModelConfig, optimizer,
                       shard=None) -> Dict[str, np.ndarray]:
    """``{JAX path: numpy array}`` of a port train state (bf16 leaves as
    ``np.uint16`` words). With ``shard`` a flat leaf holds this rank's
    columns and zeros elsewhere: in a data-parallel world the ranks'
    arrays sum to the global one, exactly (each element is one rank's
    value plus zeros). So does a sharded model's leaf: its shard, zeros
    elsewhere."""
    out = {}
    for leaf in train_state_leaves(state, cfg, optimizer, shard):
        full = torch.zeros(leaf.global_shape, dtype=core.DTYPES[leaf.dtype])
        for s in leaf.shards:
            idx = tuple(slice(a, b) for a, b in s.index)
            src = s.tensor.t() if s.transposed else s.tensor
            full[idx] = src.detach().cpu().reshape(full[idx].shape)
        out[leaf.path] = _to_numpy(full)
    return out


@torch.no_grad()
def load_train_state_arrays(state: Dict, arrays: Dict[str, np.ndarray],
                            cfg: ModelConfig, optimizer, shard=None) -> None:
    """Write ``{JAX path: numpy array}`` (every leaf of the train state;
    bf16 as ``np.uint16`` words) into the port train state, in place;
    with ``shard`` each flat leaf's global array gives this rank its
    columns."""
    idx = core.PackIndex()
    for path, a in arrays.items():
        idx.add_tensor(path, _from_numpy(np.asarray(a)))
    leaves = train_state_leaves(state, cfg, optimizer, shard)
    core.restore_leaves(leaves, idx, bridge=moment_bridge(cfg, optimizer))
    load_scalars(state, leaves, optimizer)
