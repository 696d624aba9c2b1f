"""Weight carry from the JAX param tree to the port's ``Decoder``.

The JAX decoder's params (``dlrover_tpu.models.decoder.init``'s nested
dict) stack per-layer tensors on axis 0 and keep matrices as
``[in, out]``. Given that tree with numpy arrays as leaves, this module
splits the layers, transposes every matrix into ``nn.Linear``'s
``[out, in]`` layout, takes ``lm_head.w`` or, for a tied model, the
embedding, and loads the result (cast to the model's dtypes) into a
``Decoder``. It reads numpy only: the caller moves arrays out of JAX.
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


@torch.no_grad()
def load_jax_params(params: Dict[str, Any], cfg: ModelConfig, *,
                    device="cuda") -> Decoder:
    """A ``Decoder`` on ``device`` holding the JAX params' values
    (matrices rounded to ``cfg.dtype``, norms kept f32)."""
    model = Decoder(cfg, device=device)
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    return model
