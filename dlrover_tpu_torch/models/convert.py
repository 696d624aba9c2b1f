"""Weight carry between the JAX param tree and the port's ``Decoder``.

The JAX decoder's params (``dlrover_tpu.models.decoder.init``'s nested
dict) stack per-layer tensors on axis 0 and keep matrices as
``[in, out]``. Given that tree with numpy arrays as leaves, this module
splits the layers, transposes every matrix into ``nn.Linear``'s
``[out, in]`` layout, takes ``lm_head.w`` or, for a tied model, the
embedding, and loads the result (cast to the model's dtypes) into a
``Decoder``. ``jax_tree_from_state_dict`` is the bridge back: a state
dict (parameters or their gradients) as the JAX tree of numpy arrays.
It reads and writes numpy only: the caller moves arrays out of and into
JAX.
"""

from typing import Any, Dict

import numpy as np
import torch

from dlrover_tpu_torch.models.config import ModelConfig
from dlrover_tpu_torch.models.decoder import Decoder

_ATTN = ("wq", "wk", "wv", "wo")


def state_dict_from_jax(params: Dict[str, Any], cfg: ModelConfig):
    """The ``Decoder`` state dict (f32 CPU tensors) for a JAX param tree
    of numpy arrays."""
    if cfg.n_experts > 0:
        raise NotImplementedError("MoE decoders are not ported yet")

    def t(a, transpose=False):
        a = np.asarray(a, np.float32)
        return torch.from_numpy(np.array(a.T if transpose else a, order="C"))

    lay = params["layers"]
    sd = {"embed.tokens": t(params["embed"]["tokens"])}
    if cfg.pos == "learned":
        sd["pos_embed.table"] = t(params["pos_embed"]["table"])
    mlp_names = ("w_gate", "w_up", "w_down") if cfg.act == "swiglu" else (
        "w_up", "w_down")
    for i in range(cfg.n_layer):
        p = f"layers.{i}."
        for name in _ATTN:
            sd[p + f"attn.{name}.weight"] = t(lay["attn"][name][i], True)
        for name in mlp_names:
            sd[p + f"mlp.{name}.weight"] = t(lay["mlp"][name][i], True)
        for ln in ("ln1", "ln2"):
            sd[p + f"{ln}.scale"] = t(lay[ln]["scale"][i])
            if cfg.norm == "layernorm":
                sd[p + f"{ln}.bias"] = t(lay[ln]["bias"][i])
    sd["final_norm.scale"] = t(params["final_norm"]["scale"])
    if cfg.norm == "layernorm":
        sd["final_norm.bias"] = t(params["final_norm"]["bias"])
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = t(params["lm_head"]["w"], True)
    return sd


def jax_tree_from_state_dict(sd: Dict[str, torch.Tensor],
                             cfg: ModelConfig) -> Dict[str, Any]:
    """The JAX param tree (numpy f32 leaves, layers stacked on axis 0,
    matrices ``[in, out]``) of a ``Decoder`` state dict, or of a dict of
    its gradients under the same names."""
    if cfg.n_experts > 0:
        raise NotImplementedError("MoE decoders are not ported yet")

    def a(name, transpose=False):
        x = sd[name].detach().float().cpu().numpy()
        return np.ascontiguousarray(x.T if transpose else x)

    def stack(fmt, transpose=False):
        return np.stack([a(fmt.format(i), transpose)
                         for i in range(cfg.n_layer)])

    mlp_names = ("w_gate", "w_up", "w_down") if cfg.act == "swiglu" else (
        "w_up", "w_down")
    layers = {
        "attn": {n: stack("layers.{}.attn.%s.weight" % n, True)
                 for n in _ATTN},
        "mlp": {n: stack("layers.{}.mlp.%s.weight" % n, True)
                for n in mlp_names},
    }
    for ln in ("ln1", "ln2"):
        layers[ln] = {"scale": stack("layers.{}.%s.scale" % ln)}
        if cfg.norm == "layernorm":
            layers[ln]["bias"] = stack("layers.{}.%s.bias" % ln)
    tree = {"embed": {"tokens": a("embed.tokens")}, "layers": layers,
            "final_norm": {"scale": a("final_norm.scale")}}
    if cfg.norm == "layernorm":
        tree["final_norm"]["bias"] = a("final_norm.bias")
    if cfg.pos == "learned":
        tree["pos_embed"] = {"table": a("pos_embed.table")}
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": a("lm_head.weight", True)}
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
