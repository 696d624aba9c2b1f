"""The bridge between the JAX train state and the port's.

The JAX decoder's params (``dlrover_tpu.models.decoder.init``'s nested
dict) stack per-layer tensors on axis 0 and keep matrices as
``[in, out]``; the port's ``Decoder`` keeps one ``nn.Linear`` a layer,
``[out, in]``, and ties the head to the embedding where the config
says so. ``param_table`` is that correspondence, leaf by leaf, and
everything here reads it:

- ``state_dict_from_jax`` / ``jax_tree_from_state_dict`` / ``load_jax_params``:
  a param tree of numpy arrays ⇄ a ``Decoder`` state dict (or a dict of
  its gradients under the same names);
- ``train_state_leaves``: a port train state (``train_step.init_train_state``)
  as the flattened leaves of the JAX train state, ``params/...``, the
  AdamW moments and counts under the optax state's paths for the same
  optimizer settings, and ``step``. A stacked leaf's L shards are the
  port's L per-layer tensors (transposed where the port keeps
  ``[out, in]``). The checkpoint pack writes and restores these leaves,
  so a pack restores in either package;
- ``train_state_arrays`` / ``load_train_state_arrays``: the same leaves
  as ``{path: numpy array}`` (bf16 as ``np.uint16`` words: no ml_dtypes),
  the flattened JAX train state of numpy arrays.

It reads and writes numpy only: the caller moves arrays out of and into
JAX.
"""

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.checkpoint import core
from dlrover_tpu_torch.models.config import ModelConfig
from dlrover_tpu_torch.models.decoder import Decoder

_ATTN = ("wq", "wk", "wv", "wo")

# (JAX path, port name, or its per-layer format, stacked, transposed)
ParamRow = Tuple[str, str, bool, bool]


def param_table(cfg: ModelConfig) -> List[ParamRow]:
    """Each param leaf of the JAX tree and the port tensor(s) behind it."""
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "MoE decoders are not ported yet (ROADMAP A16)")
    mlp = ("w_gate", "w_up", "w_down") if cfg.act == "swiglu" else (
        "w_up", "w_down")
    norm = ("scale", "bias") if cfg.norm == "layernorm" else ("scale",)
    rows: List[ParamRow] = [("embed/tokens", "embed.tokens", False, False)]
    if cfg.pos == "learned":
        rows.append(("pos_embed/table", "pos_embed.table", False, False))
    rows += [(f"layers/attn/{n}", f"layers.{{}}.attn.{n}.weight", True, True)
             for n in _ATTN]
    rows += [(f"layers/mlp/{n}", f"layers.{{}}.mlp.{n}.weight", True, True)
             for n in mlp]
    rows += [(f"layers/{ln}/{k}", f"layers.{{}}.{ln}.{k}", True, False)
             for ln in ("ln1", "ln2") for k in norm]
    rows += [(f"final_norm/{k}", f"final_norm.{k}", False, False)
             for k in norm]
    if not cfg.tie_embeddings:
        rows.append(("lm_head/w", "lm_head.weight", False, True))
    return rows


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _set(tree, path, value):
    *head, last = path.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def state_dict_from_jax(params: Dict[str, Any], cfg: ModelConfig):
    """The ``Decoder`` state dict (f32 CPU tensors) for a JAX param tree
    of numpy arrays."""
    def t(a, transpose):
        a = np.asarray(a, np.float32)
        return torch.from_numpy(np.array(a.T if transpose else a, order="C"))

    sd = {}
    for path, name, stacked, transposed in param_table(cfg):
        a = _get(params, path)
        if stacked:
            for i in range(cfg.n_layer):
                sd[name.format(i)] = t(a[i], transposed)
        else:
            sd[name] = t(a, transposed)
    return sd


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
                    device="cuda", trainable: bool = False) -> Decoder:
    """A ``Decoder`` on ``device`` holding the JAX params' values: frozen
    matrices rounded to ``cfg.dtype`` (serving), or with ``trainable``
    every parameter trainable in ``cfg.param_dtype``; norms f32."""
    model = Decoder(cfg, device=device, trainable=trainable)
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
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
                   cfg: ModelConfig) -> List[core.Leaf]:
    leaves = []
    for path, name, stacked, transposed in param_table(cfg):
        if stacked:
            ts = [tensors[name.format(i)] for i in range(cfg.n_layer)]
        else:
            ts = [tensors[name]]
        inner = list(ts[0].shape[::-1] if transposed else ts[0].shape)
        if stacked:
            gshape = [cfg.n_layer] + inner
            shards = [core.Shard([[i, i + 1]] + [[0, d] for d in inner],
                                 t.detach(), transposed)
                      for i, t in enumerate(ts)]
        else:
            gshape = inner
            shards = [core.Shard([[0, d] for d in inner], ts[0].detach(),
                                 transposed)]
        leaves.append(core.Leaf(f"{prefix}/{path}",
                                core.dtype_name(ts[0].dtype), gshape, shards))
    return leaves


def _scalar_leaf(path: str, value: int) -> core.Leaf:
    return core.Leaf(path, "int32", [],
                     [core.Shard([], torch.tensor(value, dtype=torch.int32))])


def train_state_leaves(state: Dict, cfg: ModelConfig,
                       optimizer) -> List[core.Leaf]:
    """The port train state as the JAX train state's flattened leaves, in
    JAX's order (dict keys sorted). The tensors are the state's own
    (detached views): a restore into these leaves writes the state; the
    scalars (``step``, the counts) are copies that ``load_scalars`` puts
    back."""
    opt = state["opt_state"]
    params = dict(state["params"].named_parameters())
    counts, mu, nu = opt_state_paths(optimizer)
    leaves = (_tensor_leaves("params", params, cfg)
              + _tensor_leaves(mu, opt["m"], cfg)
              + _tensor_leaves(nu, opt["v"], cfg)
              + [_scalar_leaf(c, opt["step"]) for c in counts]
              + [_scalar_leaf("step", state["step"])])
    return sorted(leaves, key=lambda leaf: leaf.path.split("/"))


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


def train_state_arrays(state: Dict, cfg: ModelConfig,
                       optimizer) -> Dict[str, np.ndarray]:
    """``{JAX path: numpy array}`` of a port train state (bf16 leaves as
    ``np.uint16`` words)."""
    out = {}
    for leaf in train_state_leaves(state, cfg, optimizer):
        full = torch.empty(leaf.global_shape, dtype=core.DTYPES[leaf.dtype])
        for s in leaf.shards:
            idx = tuple(slice(a, b) for a, b in s.index)
            src = s.tensor.t() if s.transposed else s.tensor
            full[idx] = src.detach().cpu().reshape(full[idx].shape)
        out[leaf.path] = _to_numpy(full)
    return out


@torch.no_grad()
def load_train_state_arrays(state: Dict, arrays: Dict[str, np.ndarray],
                            cfg: ModelConfig, optimizer) -> None:
    """Write ``{JAX path: numpy array}`` (every leaf of the train state;
    bf16 as ``np.uint16`` words) into the port train state, in place."""
    idx = core.PackIndex()
    for path, a in arrays.items():
        idx.add_tensor(path, _from_numpy(np.asarray(a)))
    leaves = train_state_leaves(state, cfg, optimizer)
    core.restore_leaves(leaves, idx)
    load_scalars(state, leaves, optimizer)
