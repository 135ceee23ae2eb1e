"""Build the port's :class:`~repro_torch.models.transformer.Transformer` from
a flat parameter dict with the JAX package's keys and shapes."""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..config.base import ModelConfig, RunConfig
from ..core.graph import resolve_device
from .transformer import Transformer, model_defs

_BIASES = {"attn/bq": "attn.wq.bias", "attn/bk": "attn.wk.bias",
           "attn/bv": "attn.wv.bias"}
#: 2-D per-block weights kept in the JAX layout (parameters, not Linears)
_AS_IS = ("moe/router",)


def _block_key(name: str, per_block_ndim: int) -> "tuple[str, bool]":
    """Module key of one block's ``<name>`` (a ``layers/`` slice or a
    ``dense{i}/`` leaf), and whether it is transposed (a 2-D weight
    becomes an ``nn.Linear`` weight)."""
    if name in _BIASES:
        return _BIASES[name], False
    key = name.replace("/", ".")
    if per_block_ndim == 2 and name not in _AS_IS:
        return key + ".weight", True
    return key, False


def from_jax_params(cfg: ModelConfig,
                    params: "Mapping[str, np.ndarray | torch.Tensor]", *,
                    run: Optional[RunConfig] = None, device=None,
                    dtype: Optional[torch.dtype] = None) -> Transformer:
    """The port's module holding the weights of a JAX-layout flat dict.

    ``params`` has exactly the keys and shapes of ``model_defs(cfg)`` (as
    ``repro.models.transformer.init_model`` returns them, pulled to numpy,
    or as :func:`~repro_torch.models.transformer.init_model` makes them);
    anything else raises.  Each array is converted once to ``device``
    (``None`` means ``"cuda"``) and ``dtype`` (default
    ``run.param_dtype``); a tensor already there is used as it is.  Then:

    * ``embed`` (V, d) -> ``embed.weight`` (V, d), as it is;
    * ``unembed`` (d, V) -> ``unembed.weight`` (V, d), transposed;
    * ``final_ln`` (d,) -> ``final_ln``;
    * every ``layers/<name>`` stack (L, ...) is split along its first dim,
      slice i going to ``layers[i]``, and every ``dense{i}/<name>`` leaf
      goes to ``dense[i]`` (deepseek-v2's leading dense block):
      - ``ln1``, ``ln2`` (d,) -> ``.ln1``, ``.ln2``;
      - 2-D weights (in, out) -> the ``nn.Linear`` of the same path, its
        ``.weight`` (out, in) transposed: ``attn/wq``, ``attn/wk``,
        ``attn/wv``, ``attn/wo``; MLA's ``attn/wq_a``, ``attn/wq_b``,
        ``attn/wkv_a``, ``attn/wk_b``, ``attn/wv_b``, ``attn/wo``;
        ``mlp/w_gate``, ``mlp/w_up``, ``mlp/w_down`` and the shared
        experts' ``moe/shared/w_gate`` ...;
      - ``attn/bq``, ``attn/bk``, ``attn/bv`` (out,) -> ``.attn.wq.bias``,
        ``.wk.bias``, ``.wv.bias``;
      - 1-D norms (``attn/q_norm``, ``attn/k_norm``, MLA's
        ``attn/kv_norm``) as they are;
      - ``moe/router`` (d, E) and the expert stacks ``moe/w_gate``,
        ``moe/w_up`` (E, d, f), ``moe/w_down`` (E, f, d) as they are, in
        the JAX layout.

    The splits and transposes are views of the converted arrays: no weight
    is copied a second time (a full-width bf16 model takes its 8.8 GB
    once).  Returns the module in eval mode without gradients.
    """
    run = run or RunConfig()
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, run.param_dtype)
    defs = model_defs(cfg)
    if set(params) != set(defs):
        raise KeyError(f"params do not match model_defs({cfg.name}): missing "
                       f"{sorted(set(defs) - set(params))}, unexpected "
                       f"{sorted(set(params) - set(defs))}")
    t = {}
    for key, val in params.items():
        if tuple(val.shape) != tuple(defs[key].shape):
            raise ValueError(f"{key}: shape {tuple(val.shape)}, want "
                             f"{defs[key].shape}")
        if not isinstance(val, torch.Tensor):
            val = torch.from_numpy(np.array(val))
        t[key] = val.to(device=dev, dtype=dtype)

    sd = {"embed.weight": t["embed"], "final_ln": t["final_ln"]}
    if not cfg.tie_embeddings:
        sd["unembed.weight"] = t["unembed"].T
    for key, val in t.items():
        head, _, name = key.partition("/")
        if head == "layers":
            mod, transpose = _block_key(name, val.dim() - 1)
            for i in range(val.shape[0]):
                sd[f"layers.{i}.{mod}"] = val[i].T if transpose else val[i]
        elif head.startswith("dense"):
            mod, transpose = _block_key(name, val.dim())
            sd[f"dense.{head[len('dense'):]}.{mod}"] = (val.T if transpose
                                                       else val)
    with torch.device("meta"):
        model = Transformer(cfg, run)
    model.load_state_dict(sd, strict=True, assign=True)
    return model.requires_grad_(False).eval()
